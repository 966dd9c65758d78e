"""The port's driver entry points (``frustum_convnet_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")`` against JAX's ``entry()``: the same example batch,
  and with JAX's variables carried across by ``models/weights.from_jax``
  every decoded output within atol/rtol 1e-4, the tolerance of
  ``tests/test_torch_infer.py`` and ``tests/test_torch_model.py`` for a
  float32 forward at full width (the two backends sum the matmuls and
  convolutions in different orders); the CLI prints the output shapes;
* ``dryrun_multichip(2, "cpu")`` runs 2 gloo ranks to the end: finite
  losses, its audit passed at 1 and 2 ranks, and the JAX dry-run's lines;
* the collective audit (``parallel/mesh.audit`` with
  ``graft_entry.check_step_collectives``) passes a sound step, and refuses
  a planted all-gather of a batch-sized tensor inside a step and a planted
  all-reduce larger than its bound.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from frustum_convnet_tpu_torch import graft_entry
from frustum_convnet_tpu_torch.models.weights import from_jax
from frustum_convnet_tpu_torch.parallel import mesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def test_entry_matches_jax_entry(capsys):
    jfn, (variables, jpts, joh, jrefs) = graft.entry()
    want = jax.jit(jfn)(variables, jpts, joh, jrefs)
    fn, (model, pts, one_hot, refs) = graft_entry.entry(device="cpu")
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(one_hot.numpy(), np.asarray(joh))
    for r, jr in zip(refs, jrefs):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    model.load_state_dict(from_jax(jax.device_get(variables["params"]),
                                   jax.device_get(variables["batch_stats"]), len(refs)),
                          strict=True)
    got = fn(model, pts, one_hot, refs)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == torch.float32 and torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=k, **TOL)
    assert graft_entry.main(["--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "entry forward OK:" in printed and "'cls_probs': (4, 140, 2)" in printed


def test_entry_weights_are_the_seeded_init():
    """Two calls give the same weights (an explicit generator, seed 3) and
    the same outputs; without a card the default device raises."""
    fn, args = graft_entry.entry(device="cpu")
    fn2, args2 = graft_entry.entry(device="cpu")
    for (k, v), v2 in zip(args[0].state_dict().items(), args2[0].state_dict().values()):
        assert torch.equal(v, v2), k
    a, b = fn(*args), fn2(*args2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not args[0].training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            graft_entry.entry()


def test_dryrun_multichip_two_gloo_ranks(capsys):
    res = graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert res["backend"] == "gloo" and res["step"] == 1
    assert np.isfinite(res["total_loss"]) and np.isfinite(res["IoU_3D"])
    assert res["infer_dets"] > 0
    assert [nd for nd, _, _ in res["scaling"]] == [1, 2]
    for nd, audit in res["audits"].items():
        assert set(audit["counts"]) == {"all-reduce"} and audit["largest"] <= audit["bound"]
    assert set(res["families"]) == {"refine_car", "det_sample_sunrgbd"}
    assert all(np.isfinite(f["total_loss"]) for f in res["families"].values())
    # a rank at world 1: its audited step, a warm-up and 6 timed steps; at
    # world 2 also the inference and the two families. Kernel 1 launches
    # only on the card: the plain grouping ran every forward here
    assert res["forwards"] == 1 * (1 + 1 + 6) + 2 * (1 + 1 + 1 + 6 + 2)
    assert res["launches"] == 0
    assert f"dryrun_multichip(2): total_loss={res['total_loss']:.4f}" in out
    assert "weak_scaling devices=1 per_device_batch=2" in out
    assert "weak_scaling devices=2 per_device_batch=2" in out
    assert "dryrun_multichip(2) family=refine_car total_loss=" in out
    assert "dryrun_multichip(2) family=det_sample_sunrgbd total_loss=" in out


@pytest.fixture
def world_one(monkeypatch):
    """This process as the one rank of a gloo group."""
    port = graft_entry._free_port()
    monkeypatch.setenv("FRUSTUM_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("FRUSTUM_NUM_PROCESSES", "1")
    monkeypatch.setenv("FRUSTUM_PROCESS_ID", "0")
    assert mesh.maybe_initialize_distributed("cpu")
    try:
        yield
    finally:
        mesh.shutdown()


def _audited_step(plant=None):
    """One tiny flagship train step inside ``mesh.audit``, with ``plant``
    as a forward hook of the model; the audit's verdict."""
    _cfg, spec, model = graft_entry._flagship(tiny=True)
    state, step = graft_entry._train_state(spec, model, torch.device("cpu"))
    if plant is not None:
        model.register_forward_hook(plant)
    batch = graft_entry._rank_batch(spec, 1, 0, 0, torch.device("cpu"))
    with mesh.audit() as records:
        losses, _ = step(state, batch)
    assert torch.isfinite(losses["total_loss"])
    return graft_entry.check_step_collectives(records, model.parameters()), records


def test_audit_passes_a_sound_step(world_one):
    calls, original = mesh.all_reduce.calls, dist.all_reduce
    audit, records = _audited_step()
    assert audit["counts"] == {"all-reduce": len(records)} and len(records) > 10
    assert mesh.all_reduce.calls - calls == len(records)
    assert 0 < audit["largest"] <= audit["bound"]
    assert dist.all_reduce is original  # the block put torch.distributed back


def test_audit_refuses_a_planted_all_gather(world_one):
    def gather_points(module, inputs, output):
        pts = inputs[0]
        dist.all_gather([torch.empty_like(pts)], pts.contiguous())

    with pytest.raises(AssertionError, match="other than all-reduce"):
        _audited_step(gather_points)


def test_audit_refuses_an_all_reduce_over_the_bound(world_one):
    def big_reduce(module, inputs, output):
        largest = max(p.numel() for p in module.parameters())
        mesh.all_reduce(torch.zeros(3 * largest))

    with pytest.raises(AssertionError, match="over the bound"):
        _audited_step(big_reduce)
