"""Ray-Client-equivalent: drive a remote cluster from a process that never
joins it (≈ `python/ray/util/client/`).

Usage (either form):

    import ray_tpu_torch as rt
    rt.init(address="client://head-host:10001")
    # ... rt.remote / get / put / actors as usual ...

    # or explicitly:
    from ray_tpu_torch.util import client
    ctx = client.connect("head-host:10001")

Server side (on any cluster host):

    python -m ray_tpu_torch.util.client.server --cluster <controller host:port>

Counterpart: ``ray_tpu/util/client/``. A tensor crosses the client wire as
the port's serialization carries it (raw bytes, dtype and shape), so a
result comes back to the client as a CPU tensor, bit for bit, and a client
process never needs a card.
"""

from ray_tpu_torch.util.client.client import ClientContext
from ray_tpu_torch.util.client.common import ClientActorHandle, ClientObjectRef
from ray_tpu_torch.util.client.server import ClientServer


def connect(address: str, *, namespace: str = "default") -> ClientContext:
    """Connect the current process to a client server and install the
    context as the module-level API backend."""
    from ray_tpu_torch._private import api

    # reject before building a live context (threads + a server session)
    if api._core is not None:
        raise RuntimeError(
            "cannot enter client mode: this process already runs a driver "
            "(call shutdown() first)")
    ctx = ClientContext(address, namespace=namespace)
    try:
        api._install_client(ctx)
    except BaseException:
        ctx.disconnect()
        raise
    return ctx


def disconnect() -> None:
    from ray_tpu_torch._private import api

    api._uninstall_client()


__all__ = [
    "ClientActorHandle",
    "ClientContext",
    "ClientObjectRef",
    "ClientServer",
    "connect",
    "disconnect",
]
