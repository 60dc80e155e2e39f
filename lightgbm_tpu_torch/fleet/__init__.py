"""The serving fleet (counterpart of ``lightgbm_tpu/fleet``): many
models behind one front door that share one card's memory, replicated
serving over logical devices with failover, stored bucket programs and
low-precision models.

Quick start::

    fleet = lightgbm_tpu_torch.Fleet(max_batch_rows=512)
    fleet.add_model("ranker", "ranker.txt", weight=3.0,
                    deadline_class="interactive")
    fleet.add_model("scorer", booster, precision="bf16",
                    accuracy_budget=1e-2)
    scores = fleet.predict("ranker", X)        # or .submit() -> Future
    fleet.export_aot("/path/to/store")         # restorable programs
    print(fleet.prometheus_text())             # model="..."-labelled
    fleet.close()

    pod = lightgbm_tpu_torch.PodFleet(devices=4)
    pod.add_model("ranker", booster, weight=3.0,
                  deadline_class="interactive")
    scores = pod.predict("ranker", X)   # health-routed, hedged, replicated
    pod.kill_device(2)                  # a replan, not an outage

Both run on the CUDA card unless ``device="cpu"``.  Module map:
``registry`` (``Fleet``: weighted admission, deadline classes,
residency replans), ``topology`` (placement planner: replicate hot
models, partition the cold tail), ``router`` (``PodFleet``:
health-scored routing, hedged retries, brownout, device-loss failover
over logical devices on one backend), ``aot`` (stored bucket programs:
B1's records, launch shapes and epilogue verdict), ``lowprec`` (bf16 /
int8 forests and their accuracy measurement).  The single-model
building blocks stay in ``lightgbm_tpu_torch.serving``.
"""

from .aot import AOTStore, aot_dir_from_env
from .lowprec import (PRECISIONS, bf16_round, forest_precision_bytes,
                      int8_rows, measure_accuracy_delta, quantize_forest)
from .registry import (DEFAULT_DEADLINE_CLASSES, Fleet, FleetConfig,
                       FleetEntry)
from .router import PodFleet, RouterConfig
from .topology import (DeviceSpec, TopologyPlan, plan_devices,
                       plan_topology)

__all__ = [
    "Fleet", "FleetConfig", "FleetEntry", "DEFAULT_DEADLINE_CLASSES",
    "PodFleet", "RouterConfig", "DeviceSpec", "TopologyPlan",
    "plan_devices", "plan_topology",
    "AOTStore", "aot_dir_from_env", "quantize_forest",
    "measure_accuracy_delta",
    "PRECISIONS", "bf16_round", "int8_rows", "forest_precision_bytes",
]
