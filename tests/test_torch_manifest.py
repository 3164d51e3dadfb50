"""The port's manifest loader (``batch_scheduler_tpu_torch/api/manifest.py``)
against the JAX package's: every document of ``examples/*.yaml`` and
``deploy/crd.yaml``, and manifests drawn by hypothesis (PodGroups, Pods,
Nodes and the four workload kinds, with quantities, durations, selectors,
tolerations and taints), parse to the same objects in both packages —
field for field, exactly. Both read the YAML with PyYAML, so the parsed
documents are ``yaml.safe_load_all``'s in both; the errors raised on a
malformed duration or quantity are the same too."""

import dataclasses
import enum
import glob
import importlib
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml"))) + [
    os.path.join(REPO, "deploy", "crd.yaml")]


def _manifest(pkg):
    return importlib.import_module(f"{pkg}.api.manifest")


def plain(obj):
    """An object tree as plain data: dataclasses by class name and fields,
    enums by value."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


def both(text):
    return [plain(_manifest(pkg).load_manifests(text)) for pkg in PACKAGES]


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_repo_manifests_parse_alike(path):
    """The README's examples and the CRD: the same objects in both
    packages, from the file and from each of its documents alone."""
    ref, port = (plain(_manifest(pkg).load_manifest_file(path)) for pkg in PACKAGES)
    assert ref == port
    with open(path) as f:
        text = f.read()
    for doc in yaml.safe_load_all(text):
        a, b = both(yaml.safe_dump(doc))
        assert a == b


def test_examples_give_the_readme_objects():
    """What the CLI runs: race.yaml one 7.1-cpu node, two gangs of 5 and
    ten pods; example1.yaml a gang of 9 and its nine pods; zones.yaml two
    zoned nodes, a pinned and a free gang."""
    from batch_scheduler_tpu_torch.api.types import Node, Pod, PodGroup

    counts = {}
    for path in FILES[:-1]:
        objs = _manifest(PACKAGES[1]).load_manifest_file(path)
        counts[os.path.basename(path)] = tuple(
            sum(isinstance(o, t) for o in objs) for t in (Node, PodGroup, Pod))
    assert counts == {"example1.yaml": (0, 1, 9), "race.yaml": (1, 2, 10),
                      "zones.yaml": (2, 2, 7)}
    node = _manifest(PACKAGES[1]).load_manifest_file(os.path.join(REPO, "examples", "race.yaml"))[0]
    assert node.status.allocatable == {"cpu": 7100, "memory": 32 * 1024**3, "pods": 110}


@pytest.mark.parametrize("value", [None, 90, 2.5, "30s", "1m30s", "500ms", "1h2m3s", "2.5m",
                                   "45", "tomorrow", "5x", ""])
def test_duration_parsing_alike(value):
    got = []
    for pkg in PACKAGES:
        try:
            got.append(("ok", _manifest(pkg)._duration_seconds(value)))
        except ValueError as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]


_names = st.from_regex(r"[a-z][a-z0-9-]{0,10}", fullmatch=True)
_quantity = st.one_of(
    st.integers(1, 64).map(str),
    st.integers(1, 4000).map(lambda m: f"{m}m"),
    st.sampled_from(["1Gi", "512Mi", "2G", "1.5", "100k"]),
)
_resources = st.dictionaries(st.sampled_from(["cpu", "memory", "pods", "nvidia.com/gpu"]),
                             _quantity, max_size=3)
_labels = st.dictionaries(st.sampled_from(["zone", "pool", "team",
                                           "pod-group.batch.scheduler.tpu"]),
                          _names, max_size=2)


@st.composite
def _pod_spec(draw):
    spec = {"containers": [
        {"name": draw(_names),
         "resources": {"requests": draw(_resources), "limits": draw(_resources)}}
        for _ in range(draw(st.integers(0, 2)))]}
    if draw(st.booleans()):
        spec["nodeSelector"] = draw(_labels)
    if draw(st.booleans()):
        spec["tolerations"] = [{"key": draw(_names),
                                "operator": draw(st.sampled_from(["Equal", "Exists"])),
                                "value": draw(_names),
                                "effect": draw(st.sampled_from(["", "NoSchedule"]))}]
    if draw(st.booleans()):
        spec["priority"] = draw(st.integers(-5, 100))
    return spec


@st.composite
def _document(draw):
    kind = draw(st.sampled_from(["PodGroup", "Pod", "Node", "StatefulSet", "Deployment",
                                 "ReplicaSet", "Job", "Service"]))
    meta = {"name": draw(_names), "labels": draw(_labels)}
    if draw(st.booleans()):
        meta["namespace"] = draw(_names)
    doc = {"apiVersion": "v1", "kind": kind, "metadata": meta}
    if kind == "PodGroup":
        spec = {"minMember": draw(st.integers(0, 64))}
        if draw(st.booleans()):
            spec["minResources"] = draw(_resources)
        if draw(st.booleans()):
            spec["maxScheduleTime"] = draw(st.one_of(
                st.integers(1, 3600), st.sampled_from(["30s", "5m", "1h2m", "250ms"])))
        doc["spec"] = spec
    elif kind == "Pod":
        doc["spec"] = draw(_pod_spec())
    elif kind == "Node":
        doc["status"] = {"allocatable": draw(_resources)}
        if draw(st.booleans()):
            doc["status"]["capacity"] = draw(_resources)
        doc["spec"] = {"unschedulable": draw(st.booleans()),
                       "taints": [{"key": draw(_names), "value": draw(_names)}]
                       if draw(st.booleans()) else []}
    elif kind != "Service":
        count = draw(st.integers(0, 4))
        doc["spec"] = {"parallelism" if kind == "Job" else "replicas": count,
                       "template": {"metadata": {"labels": draw(_labels)},
                                    "spec": draw(_pod_spec())}}
    return doc


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_document(), min_size=1, max_size=5))
def test_drawn_manifests_parse_alike(docs):
    """Multi-document manifests of every kind the loader reads (and one it
    skips) give the same objects, or the same error, in both packages."""
    text = yaml.safe_dump_all(docs)
    got = []
    for pkg in PACKAGES:
        try:
            got.append(("ok", plain(_manifest(pkg).load_manifests(text))))
        except (ValueError, ArithmeticError) as e:
            got.append(("error", type(e).__name__, str(e)))
    assert got[0] == got[1]


def test_expand_job_uses_parallelism_alike():
    doc = {"kind": "Job", "metadata": {"name": "j", "namespace": "ns1"},
           "spec": {"parallelism": 3, "template": {
               "metadata": {"labels": {"pod-group.batch.scheduler.tpu": "g"}},
               "spec": {"containers": [{"name": "c", "resources": {
                   "requests": {"cpu": "500m"}}}]}}}}
    ref, port = (plain(_manifest(pkg).expand_workload(doc)) for pkg in PACKAGES)
    assert ref == port
    pods = _manifest(PACKAGES[1]).expand_workload(doc)
    assert [p.metadata.name for p in pods] == ["j-0", "j-1", "j-2"]
    assert pods[0].resource_require() == {"cpu": 500}
    assert _manifest(PACKAGES[0]).WORKLOAD_KINDS == _manifest(PACKAGES[1]).WORKLOAD_KINDS
