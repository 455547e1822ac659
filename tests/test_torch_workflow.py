"""The port's durable workflows (``ray_tpu_torch.workflow``) on a CPU
cluster: the twins of ``tests/test_dag_workflow.py``'s ``TestWorkflow``
(run checkpoints every step and a resume re-runs none; a failed step
resumes from the steps that did complete; ``delete``), and step results
that are tensors: stored through the port's serialization, a bf16 step
result loads back on the CPU bit for bit, and the resumed run returns
the same bits without running the step again. A step's identity is
structural in both packages: the same DAG under the same inputs keeps
its step ids, a changed constant changes only its own subtree's.
"""

import os
import sys

import cloudpickle
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    """A JAX runtime that an earlier test file left up in this worker (JAX's
    serve router threads restart a shut one) is shut down after this file,
    so the next JAX file in the worker does not meet it (ROADMAP §C)."""
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=128 * 1024 * 1024)
    yield
    rt.shutdown()


@rt.remote
def _add(a, b):
    return a + b


def test_run_checkpoints_and_resume_skips(cluster, tmp_path):
    marker_dir = str(tmp_path / "markers")
    os.makedirs(marker_dir)

    @rt.remote
    def counted(tag, x):
        # one marker per EXECUTION (not per resume)
        open(os.path.join(marker_dir, f"{tag}-{os.urandom(4).hex()}"),
             "w").close()
        return x * 2

    with InputNode() as inp:
        dag = counted.bind("s2", counted.bind("s1", inp))

    out = workflow.run(dag, 3, workflow_id="wf-test",
                       storage=str(tmp_path / "wf"))
    assert out == 12
    assert len(os.listdir(marker_dir)) == 2

    # resume: every step loads from its checkpoint, nothing re-executes
    assert workflow.resume("wf-test", storage=str(tmp_path / "wf")) == 12
    assert len(os.listdir(marker_dir)) == 2
    assert workflow.list_all(storage=str(tmp_path / "wf")) == [
        {"workflow_id": "wf-test", "status": "SUCCEEDED"}]


def test_failed_step_resumes_from_checkpoint(cluster, tmp_path):
    flag = str(tmp_path / "fail-once")
    open(flag, "w").close()
    marker_dir = str(tmp_path / "markers2")
    os.makedirs(marker_dir)

    @rt.remote
    def good(x):
        open(os.path.join(marker_dir, os.urandom(4).hex()), "w").close()
        return x + 100

    @rt.remote
    def flaky(x, flag_path):
        if os.path.exists(flag_path):
            raise RuntimeError("transient failure")
        return x + 1

    with InputNode() as inp:
        dag = flaky.bind(good.bind(inp), flag)

    with pytest.raises(Exception, match="transient"):
        workflow.run(dag, 1, workflow_id="wf-fail",
                     storage=str(tmp_path / "wf"))
    assert len(os.listdir(marker_dir)) == 1  # good() ran and was kept
    assert workflow.list_all(
        storage=str(tmp_path / "wf"))[0]["status"] == "FAILED"

    os.remove(flag)  # clear the failure
    assert workflow.resume("wf-fail", storage=str(tmp_path / "wf")) == 102
    assert len(os.listdir(marker_dir)) == 1  # good() did NOT rerun


def test_delete(cluster, tmp_path):
    with InputNode() as inp:
        dag = _add.bind(inp, 1)
    workflow.run(dag, 1, workflow_id="wf-del", storage=str(tmp_path / "wf"))
    workflow.delete("wf-del", storage=str(tmp_path / "wf"))
    assert workflow.list_all(storage=str(tmp_path / "wf")) == []


def test_bf16_tensor_steps_keep_their_bits(cluster, tmp_path):
    marker_dir = str(tmp_path / "markers3")
    os.makedirs(marker_dir)

    @rt.remote
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(17, 9, generator=g).to(torch.bfloat16)

    @rt.remote
    def scale(t, k):
        open(os.path.join(marker_dir, os.urandom(4).hex()), "w").close()
        return t * k

    with InputNode() as inp:
        dag = scale.bind(make.bind(inp), 3)
    storage = str(tmp_path / "wf")
    out = workflow.run(dag, 4, workflow_id="wf-t", storage=storage)
    want = torch.randn(17, 9, generator=torch.Generator().manual_seed(4)
                       ).to(torch.bfloat16) * 3
    assert out.device.type == "cpu" and out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    again = workflow.resume("wf-t", storage=storage)
    assert torch.equal(again.view(torch.int16), want.view(torch.int16))
    assert len(os.listdir(marker_dir)) == 1


def test_step_identity_is_structural(cluster, tmp_path):
    """The same DAG re-run under its id loads every step; a changed
    constant re-runs its own step and what depends on it, nothing else."""
    marker_dir = str(tmp_path / "markers4")
    os.makedirs(marker_dir)

    @rt.remote
    def counted(tag, x, k):
        open(os.path.join(marker_dir, f"{tag}-{os.urandom(4).hex()}"),
             "w").close()
        return x * k

    def build(k2):
        with InputNode() as inp:
            return counted.bind("b", counted.bind("a", inp, 2), k2)

    storage = str(tmp_path / "wf")
    assert workflow.run(build(3), 5, workflow_id="wf-s",
                        storage=storage) == 30
    assert workflow.run(build(3), 5, workflow_id="wf-s",
                        storage=storage) == 30
    assert len(os.listdir(marker_dir)) == 2
    assert workflow.run(build(4), 5, workflow_id="wf-s",
                        storage=storage) == 40
    tags = sorted(n.split("-")[0] for n in os.listdir(marker_dir))
    assert tags == ["a", "b", "b"]
