"""Exception hierarchy.

Analog of the reference's ``ray.exceptions`` (`python/ray/exceptions.py`):
user-visible failure types for tasks, actors and objects.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray_tpu_torch.get().

    Carries the remote traceback string so the user sees the real failure
    site, matching the reference's RayTaskError formatting.
    """

    def __init__(self, function_name: str, cause: Exception | None, tb_str: str = ""):
        self.function_name = function_name
        self.cause = cause
        self.tb_str = tb_str
        super().__init__(self._format())

    def _format(self) -> str:
        msg = f"task {self.function_name} failed"
        if self.tb_str:
            msg += "\n\nremote traceback:\n" + self.tb_str
        elif self.cause is not None:
            msg += f": {self.cause!r}"
        return msg

    @classmethod
    def from_exception(cls, function_name: str, exc: Exception) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        try:
            import cloudpickle

            cloudpickle.dumps(exc)
            cause: Optional[Exception] = exc
        except Exception:
            cause = None
        return cls(function_name, cause, tb)

    def __reduce__(self):
        return (TaskError, (self.function_name, self.cause, self.tb_str))


class TaskCancelledError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead (crashed, killed, or out of restarts)."""

    def __init__(self, actor_id_hex: str = "", reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"actor {actor_id_hex} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id_hex, self.reason))


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """Object data was lost and could not be reconstructed from lineage."""

    def __init__(self, object_id_hex: str = "", reason: str = ""):
        self.object_id_hex = object_id_hex
        self.reason = reason
        super().__init__(f"object {object_id_hex} lost: {reason}")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id_hex, self.reason))


class ChannelClosedError(RayTpuError):
    """A compiled-graph channel was closed.

    Raised at every peer blocked on (or about to touch) the channel when
    the owning CompiledDAG is torn down or a participant actor/node dies.
    """


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    pass
