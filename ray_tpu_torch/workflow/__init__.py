"""Durable workflows: DAGs whose step results survive process death.

Analog of `python/ray/workflow/` (`api.py` run/resume, step checkpointing
in `workflow_executor.py`): execute a `ray_tpu_torch.dag` graph with each
node's result checkpointed to workflow storage as it completes. A crash
(or deliberate stop) mid-workflow resumes with `resume()` — completed
steps load from storage instead of re-executing, so side-effectful or
expensive steps run at most once per success.

Step identity is structural: a node's id hashes its function name, its
constant args, and its upstream step ids, so the same DAG resumes
correctly while a CHANGED dag invalidates only the changed subtree.

Counterpart: ``ray_tpu/workflow/__init__.py``. Step results are stored
through the port's serialization, so a tensor step result is stored as
its raw bytes and loads back on the CPU, bit for bit.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import serialization as _ser
from ray_tpu_torch.dag import (ClassMethodNode, DAGNode, FunctionNode, InputNode,
                        MultiOutputNode)

__all__ = ["run", "resume", "list_all", "delete"]

_DEFAULT_ROOT = os.path.expanduser("~/.ray_tpu_torch_workflows")


def _storage_root(storage: Optional[str]) -> str:
    root = storage or os.environ.get("RAY_TPU_TORCH_WORKFLOW_STORAGE",
                                     _DEFAULT_ROOT)
    os.makedirs(root, exist_ok=True)
    return root


def _value_bytes(v: Any) -> bytes:
    """Stable value encoding for step identity: serialized content, NOT
    repr (a default repr embeds a memory address, which changes across
    resume and would invalidate every checkpoint)."""
    try:
        return _ser.dumps(v)
    except Exception:
        return repr(v).encode()


def _node_id(node: DAGNode, inputs_fingerprint: str,
             memo: Dict[int, str]) -> str:
    if id(node) in memo:
        return memo[id(node)]
    h = hashlib.sha256()

    def feed(b: bytes) -> None:
        # length-prefix every component: 'f'+'12'+'3' must not collide
        # with 'f'+'1'+'23'
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)

    if isinstance(node, InputNode):
        feed(f"input:{node.index}:{inputs_fingerprint}".encode())
    elif isinstance(node, MultiOutputNode):
        feed(b"multi")
        for c in node._outputs:
            feed(_node_id(c, inputs_fingerprint, memo).encode())
    else:
        if isinstance(node, FunctionNode):
            fn = node._fn
            name = getattr(getattr(fn, "_fn", None), "__qualname__",
                           None) or repr(type(fn))
            feed(b"fn")
            feed(str(name).encode())
        else:
            m = node._method
            # actor identity is part of the step: same-named methods on
            # DIFFERENT actors are different steps
            actor_hex = ""
            handle = getattr(m, "_handle", None)
            actor_id = getattr(handle, "_actor_id", None)
            if actor_id is not None:
                actor_hex = actor_id.hex()
            feed(b"actor")
            feed(actor_hex.encode())
            feed(str(getattr(m, "_name", "")).encode())
        for a in node._args:
            if isinstance(a, DAGNode):
                feed(b"dep:" + _node_id(a, inputs_fingerprint, memo).encode())
            else:
                feed(b"arg")
                feed(_value_bytes(a))
        for k in sorted(node._kwargs):
            v = node._kwargs[k]
            feed(b"kw")
            feed(k.encode())
            if isinstance(v, DAGNode):
                feed(b"dep:" + _node_id(v, inputs_fingerprint, memo).encode())
            else:
                feed(_value_bytes(v))
    out = h.hexdigest()[:24]
    memo[id(node)] = out
    return out


class _WorkflowRun:
    def __init__(self, workflow_id: str, root: str):
        self.workflow_id = workflow_id
        self.dir = os.path.join(root, workflow_id)

    def ensure_dirs(self) -> None:
        # only write paths create storage — read paths (list/resume of a
        # typo'd id) must not leave empty directories behind
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", step_id + ".pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self._step_path(step_id), "rb") as f:
            return _ser.loads(f.read())

    def save_step(self, step_id: str, value: Any) -> None:
        self.ensure_dirs()
        tmp = self._step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_ser.dumps(value))
        os.replace(tmp, self._step_path(step_id))

    def save_meta(self, **kw) -> None:
        self.ensure_dirs()
        meta = self.load_meta()
        meta.update(kw)
        tmp = os.path.join(self.dir, "meta.pkl.tmp")
        with open(tmp, "wb") as f:
            f.write(_ser.dumps(meta))
        os.replace(tmp, os.path.join(self.dir, "meta.pkl"))

    def load_meta(self) -> Dict[str, Any]:
        try:
            with open(os.path.join(self.dir, "meta.pkl"), "rb") as f:
                return _ser.loads(f.read())
        except OSError:
            return {}


def _submit_durable(node: DAGNode, inputs: List[Any], run: _WorkflowRun,
                    fingerprint: str, memo: Dict[int, str],
                    cache: Dict[int, Any],
                    pending: List) -> Any:
    """Submission pass: checkpointed steps load their VALUE; fresh steps
    submit and return an ObjectRef (downstream tasks consume the ref, so
    independent branches run in parallel — no per-step get barrier).
    `pending` collects (step_id, ref) for the checkpoint pass."""
    if id(node) in cache:
        return cache[id(node)]
    if isinstance(node, InputNode):
        value = inputs[node.index]
    elif isinstance(node, MultiOutputNode):
        value = [
            _submit_durable(c, inputs, run, fingerprint, memo, cache,
                            pending)
            for c in node._outputs]
    else:
        step_id = _node_id(node, fingerprint, memo)
        if run.has_step(step_id):
            value = run.load_step(step_id)
        else:
            args = tuple(
                _submit_durable(a, inputs, run, fingerprint, memo, cache,
                                pending)
                if isinstance(a, DAGNode) else a for a in node._args)
            kwargs = {
                k: _submit_durable(v, inputs, run, fingerprint, memo, cache,
                                   pending)
                if isinstance(v, DAGNode) else v
                for k, v in node._kwargs.items()}
            target = (node._fn if isinstance(node, FunctionNode)
                      else node._method)
            value = target.remote(*args, **kwargs)
            pending.append((step_id, value))
    cache[id(node)] = value
    return value


def _checkpoint_pending(run: _WorkflowRun, pending: List) -> None:
    """Resolve + checkpoint every freshly-submitted step. One failing step
    must not lose the checkpoints of steps that DID complete."""
    first_error = None
    for step_id, ref in pending:
        try:
            run.save_step(step_id, ray_tpu_torch.get(ref))
        except Exception as e:  # noqa: BLE001 — re-raised after the sweep
            if first_error is None:
                first_error = e
    if first_error is not None:
        raise first_error


def _materialize(out: Any) -> Any:
    from ray_tpu_torch._private.api import ObjectRef

    if isinstance(out, ObjectRef):
        return ray_tpu_torch.get(out)
    if isinstance(out, list):
        return [_materialize(v) for v in out]
    return out


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        storage: Optional[str] = None) -> Any:
    """Execute the DAG durably; returns the final VALUE. Re-running the
    same workflow_id resumes from its checkpoints."""
    root = _storage_root(storage)
    workflow_id = workflow_id or f"wf_{int(time.time())}_{os.getpid()}"
    wf = _WorkflowRun(workflow_id, root)
    h = hashlib.sha256()
    for a in args:
        b = _value_bytes(a)
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    fingerprint = h.hexdigest()[:16]
    wf.save_meta(status="RUNNING", args=args, fingerprint=fingerprint,
                 dag=_ser.dumps(dag), start_time=time.time())
    try:
        pending: List = []
        out = _submit_durable(dag, list(args), wf, fingerprint, {}, {},
                              pending)
        _checkpoint_pending(wf, pending)
        out = _materialize(out)
    except Exception as e:
        wf.save_meta(status="FAILED", error=repr(e), end_time=time.time())
        raise
    wf.save_meta(status="SUCCEEDED", end_time=time.time())
    return out


def resume(workflow_id: str, storage: Optional[str] = None) -> Any:
    """Resume a stopped/failed workflow from its checkpoints."""
    root = _storage_root(storage)
    wf = _WorkflowRun(workflow_id, root)
    meta = wf.load_meta()
    if not meta:
        raise KeyError(f"no workflow {workflow_id!r} in {root}")
    dag = _ser.loads(meta["dag"])
    return run(dag, *meta.get("args", ()), workflow_id=workflow_id,
               storage=storage)


def list_all(storage: Optional[str] = None) -> List[Dict[str, Any]]:
    root = _storage_root(storage)
    out = []
    for wid in sorted(os.listdir(root)):
        if not os.path.isdir(os.path.join(root, wid)):
            continue  # stray file in the storage root, not a workflow
        meta = _WorkflowRun(wid, root).load_meta()
        if meta:
            out.append({"workflow_id": wid,
                        "status": meta.get("status", "UNKNOWN")})
    return out


def delete(workflow_id: str, storage: Optional[str] = None) -> None:
    import shutil

    shutil.rmtree(os.path.join(_storage_root(storage), workflow_id),
                  ignore_errors=True)


from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("workflow")
del _rlu
