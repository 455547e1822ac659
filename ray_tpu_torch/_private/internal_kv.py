"""Internal KV client — thin wrappers over the controller's KV service.

Analog of the reference's `ray.experimental.internal_kv` (backed by the GCS
internal KV, `src/ray/gcs/gcs_server/gcs_kv_manager.h`): a namespaced
key→value store used by libraries (collective group metadata, serve config,
job table) rather than by user code.
"""

from __future__ import annotations

from typing import Any, List, Optional


def _core():
    from ray_tpu_torch._private.api import _require_core

    return _require_core()


def kv_put(key: str, value: Any, *, ns: str = "default", overwrite: bool = True) -> bool:
    core = _core()
    from ray_tpu_torch._private.serialization import payload_nbytes

    size = payload_nbytes(value)
    if size > core.config.kv_max_value_bytes:
        # fail before serializing a tensor-sized frame onto the control
        # plane (the controller enforces the same cap authoritatively)
        raise ValueError(
            f"kv_put value for {key!r} is {size} bytes, above the "
            f"control-plane cap of {core.config.kv_max_value_bytes} "
            f"(RAY_TPU_TORCH_KV_MAX_VALUE_BYTES). Move tensor-sized payloads "
            f"through the object store (ray_tpu_torch.put) or the collective "
            f"data plane (ray_tpu_torch.util.collective), not the controller KV.")
    return core._run(
        core.clients.get(core.controller_addr).call(
            "kv_put", {"ns": ns, "key": key, "value": value, "overwrite": overwrite}
        )
    )


def kv_get(key: str, *, ns: str = "default") -> Optional[Any]:
    core = _core()
    return core._run(
        core.clients.get(core.controller_addr).call("kv_get", {"ns": ns, "key": key})
    )


def kv_exists(key: str, *, ns: str = "default") -> bool:
    core = _core()
    return core._run(
        core.clients.get(core.controller_addr).call("kv_exists", {"ns": ns, "key": key})
    )


def kv_del(key: str, *, ns: str = "default") -> bool:
    core = _core()
    return core._run(
        core.clients.get(core.controller_addr).call("kv_del", {"ns": ns, "key": key})
    )


def kv_wait(key: str, timeout: float = 30.0, *, ns: str = "default") -> Any:
    """Long-poll for ``key``: returns its value as soon as it exists
    (possibly immediately), raises TimeoutError after ``timeout`` seconds.
    ONE parked RPC per ~30 s slice replaces client-side sleep-and-repoll
    loops on the control plane (collective rendezvous, PG readiness).

    Controller-restart safe: a wait parked on a controller that is then
    killed fails with the severed connection — the client RE-ISSUES the
    wait under the SAME deadline budget instead of hanging or surfacing a
    spurious error. A put that landed in the controller's WAL before the
    kill resolves the re-issued wait immediately from the recovered KV
    (the server-side found-fast path); a put after recovery resolves it
    through ``_kv_notify`` as usual."""
    import time

    from ray_tpu_torch._private.rpc import RpcConnectionError, RpcTimeoutError

    core = _core()
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"kv_wait: key {key!r} (ns={ns!r}) did not appear within "
                f"{timeout}s")
        slice_s = min(remaining, 30.0)
        try:
            reply = core._run(
                core.clients.get(core.controller_addr).call(
                    "kv_wait", {"ns": ns, "key": key, "timeout": slice_s},
                    timeout=slice_s + core.config.rpc_request_timeout_s,
                )
            )
        except (RpcConnectionError, RpcTimeoutError):
            if deadline - time.monotonic() <= 0.2:
                raise TimeoutError(
                    f"kv_wait: key {key!r} (ns={ns!r}) did not appear "
                    f"within {timeout}s (controller unreachable at the "
                    f"deadline)") from None
            # controller died mid-park: re-arm after a beat (the re-issued
            # call's connect path patiently waits out the restart window)
            time.sleep(0.2)
            continue
        if reply.get("found"):
            return reply["value"]


def kv_keys(prefix: str = "", *, ns: str = "default") -> List[str]:
    core = _core()
    return core._run(
        core.clients.get(core.controller_addr).call("kv_keys", {"ns": ns, "prefix": prefix})
    )
