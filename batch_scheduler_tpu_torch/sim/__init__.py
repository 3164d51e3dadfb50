from .chaos import ChaosProxy
from .harness import SimCluster
from .kubelet import SimKubelet
from .scenarios import (
    SyntheticSpec,
    make_member_pods,
    make_sim_group,
    make_sim_node,
    race_scenario,
    synthetic_cluster,
)

__all__ = [
    "ChaosProxy",
    "SimCluster",
    "SimKubelet",
    "SyntheticSpec",
    "make_member_pods",
    "make_sim_group",
    "make_sim_node",
    "race_scenario",
    "synthetic_cluster",
]
