"""API group registration constants.

Mirror of the reference's scheme registration
(reference pkg/apis/podgroup/register.go:21, pkg/apis/podgroup/v1/register.go:28-55).
"""

GROUP_NAME = "batch.scheduler.tpu"
VERSION = "v1"
GROUP_VERSION = f"{GROUP_NAME}/{VERSION}"

KIND_POD_GROUP = "PodGroup"
PLURAL_POD_GROUPS = "podgroups"
SHORT_NAMES = ("pg", "pgs")

CRD_NAME = f"{PLURAL_POD_GROUPS}.{GROUP_NAME}"
