"""A card comes back to the node as soon as the process that held it has
exited, even when the process that owned its lease died with it:
``serve.shutdown()`` kills the serve controller, which made the replicas,
and the replica's card must not wait for the supervisor to give up on
telling that dead owner (``rpc_connect_timeout_s``, set long here so a wait
for it shows). On the CPU the card is a ``GPU`` resource that ``rt.init``
counts (``num_gpus=1``); nothing touches CUDA."""

import os
import sys
import time

import cloudpickle

import ray_tpu_torch as rt
from ray_tpu_torch import serve

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the deployment and the probe ship by value: no worker imports this module
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CONNECT_TIMEOUT_S = 30.0
# the card is back, and a new card actor up, well inside the connect window
CARD_BACK_S = 15.0


@serve.deployment(ray_actor_options={"num_gpus": 1})
class _Echo:
    def __call__(self, x):
        return {"pid": os.getpid(), "x": x}


class _Probe:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def _gone(pid) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_card_back_after_serve_shutdown():
    rt.init(num_cpus=4, num_gpus=1,
            _system_config={"rpc_connect_timeout_s": CONNECT_TIMEOUT_S})
    try:
        h = serve.run(_Echo.bind(), name="echo", route_prefix="/echo",
                      timeout_s=60)
        pid = h.remote(1).result(timeout=60)["pid"]
        assert rt.available_resources().get("GPU", 0) == 0
        serve.shutdown()
        t0 = time.monotonic()
        deadline = t0 + 2 * CONNECT_TIMEOUT_S
        while not _gone(pid) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _gone(pid), "the replica's process outlived serve.shutdown"
        while (rt.available_resources().get("GPU", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
        free_s = time.monotonic() - t0
        probe = rt.remote(_Probe).options(num_gpus=1).remote()
        assert rt.get(probe.visible.remote(),
                      timeout=2 * CONNECT_TIMEOUT_S) == "0"
        up_s = time.monotonic() - t0
        assert free_s < CARD_BACK_S and up_s < CARD_BACK_S, (
            f"the card came back {free_s:.1f} s after serve.shutdown() "
            f"returned and a card actor was up after {up_s:.1f} s")
        rt.kill(probe)
    finally:
        rt.shutdown()
