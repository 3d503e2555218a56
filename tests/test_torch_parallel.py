"""PyTorch port, data parallelism layer by layer on the CPU: two gloo ranks
(`tests/torch_mp_worker.py`, suite "parallel"), each holding half of every
case's global batch, against this process running the same case on the
whole batch without a process group:

- `BatchNorm2d` in train mode: the output and the input gradient (the
  rank's rows), the parameter gradients (summed over ranks) and the
  running statistics (on each rank), at float32 1e-6;
- `folded_1x1_weights`: W′ and b′ on each rank, the gradients as above;
- CE, the fused resize CE (K1's plain version, bf16) and the plain resize
  route, each with and without class weights, with rank 1's labels all
  255 and with unequal valid counts: the shares sum to the single loss at
  1e-6 and d(logits) are its rows;
- OHEM on both threshold routes and the resize OHEM (K3's plain version,
  and float32), with min_kept above one rank's valid pixels; the float32
  ones also against the JAX package's on the global batch at
  tests/test_torch_ohem.py's 1e-5;
- `augment_batch` and `Dropout` (plain and spatial): each rank's rows
  equal the single draw's bit for bit, and the generators stay in step;
- `evaluate`'s int64 matrix on every rank equals the single one exactly;
- `local_batch_iterator`: each rank's batches are its rows of the
  single process's, resumed at batch 1 of a shuffled stream;
- `local_shard_range` against the JAX package's formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as w
from torch_semantic_segmentation_tpu import losses as jlosses
from torch_semantic_segmentation_tpu.parallel import distributed as jdist

torch.set_num_threads(2)

R = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, this process's on the whole batches)."""
    out = str(tmp_path_factory.mktemp("parallel"))
    procs = w.launch("parallel", out, world=R)
    single = w.suite_parallel()
    return w.collect(procs, out), single


def _rows_close(ranks, single, key, **tol):
    got = torch.cat([r[key] for r in ranks])
    np.testing.assert_allclose(got.numpy(), single[key].numpy(), err_msg=key,
                               **tol)


def _summed_close(ranks, single, key, **tol):
    got = sum(r[key].double() for r in ranks)
    np.testing.assert_allclose(got.numpy(), single[key].double().numpy(),
                               err_msg=key, **tol)


def _each_close(ranks, single, key, **tol):
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r[key].numpy(), single[key].numpy(),
                                   err_msg=f"{key} on rank {i}", **tol)


TOL = dict(rtol=1e-6, atol=1e-6)


def test_batchnorm_uses_the_global_moments(runs):
    ranks, single = [r["bn"] for r in runs[0]], runs[1]["bn"]
    for key in ("y", "dx"):
        _rows_close(ranks, single, key, **TOL)
    for key in ("dweight", "dbias"):
        _summed_close(ranks, single, key, rtol=1e-6, atol=1e-5)
    for key in ("running_mean", "running_var"):
        _each_close(ranks, single, key, **TOL)


def test_folded_moments_are_the_global_batch(runs):
    ranks, single = [r["folded"] for r in runs[0]], runs[1]["folded"]
    for key in ("w", "b", "running_mean", "running_var"):
        _each_close(ranks, single, key, **TOL)
    _rows_close(ranks, single, "dx", **TOL)
    for key in ("dconv", "dconv_bias", "dgamma", "dbeta"):
        _summed_close(ranks, single, key, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("fn,pattern,weighted", w.LOSS_CASES,
                         ids=["-".join(map(str, c)) for c in w.LOSS_CASES])
def test_loss_shares_sum_to_the_single_loss(runs, fn, pattern, weighted):
    key = "loss-" + "-".join(map(str, (fn, pattern, weighted)))
    ranks, single = [r[key] for r in runs[0]], runs[1][key]
    _summed_close(ranks, single, "share", rtol=1e-6, atol=0)
    scale = float(single["dlogits"].abs().max())
    _rows_close(ranks, single, "dlogits", rtol=1e-5, atol=1e-6 * scale)
    if pattern == "rank1_ignored":
        assert float(ranks[1]["share"]) == 0.0
        assert not ranks[1]["dlogits"].any()


@pytest.mark.parametrize("fn,exact", w.OHEM_CASES,
                         ids=[f"{f}-{e}" for f, e in w.OHEM_CASES])
def test_ohem_keeps_by_the_global_threshold(runs, fn, exact, monkeypatch):
    key = f"ohem-{fn}-{exact}"
    ranks, single = [r[key] for r in runs[0]], runs[1][key]
    logits, labels, kw = w.ohem_inputs(fn, exact)
    # min_kept counts over the global batch: more than one rank's pixels
    assert kw["min_kept"] > (labels[:2] != 255).sum()
    _summed_close(ranks, single, "share", rtol=1e-6, atol=0)
    scale = float(single["dlogits"].abs().max())
    _rows_close(ranks, single, "dlogits", rtol=1e-5, atol=1e-6 * scale)
    if fn == "resize_ohem":
        return      # bf16 through K3: tests/test_torch_ohem.py holds it
    monkeypatch.setenv("TPU_SEG_PALLAS_CE", "0")
    jfn = (jlosses.ohem_cross_entropy if fn == "ohem"
           else jlosses.resize_ohem_cross_entropy)
    if exact is not None:
        kw["exact"] = exact
    value, grad = jax.value_and_grad(lambda lg: jfn(
        lg, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    got = sum(float(r["share"]) for r in ranks)
    np.testing.assert_allclose(got, float(value), rtol=1e-5)
    np.testing.assert_allclose(
        torch.cat([r["dlogits"] for r in ranks]).numpy(), np.asarray(grad),
        rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(grad)).max()))


def test_draws_are_rows_of_the_single_draw(runs):
    ranks, single = [r["draws"] for r in runs[0]], runs[1]["draws"]
    for key in ("images0", "labels0", "images1", "labels1"):
        got = torch.cat([r[key] for r in ranks])
        assert torch.equal(got, single[key]), key
    for key in ("dropout", "spatial"):
        # each rank drew twice: [first draw's rows, second draw's rows]
        n = single[key].shape[0] // 2
        for half in (0, 1):
            got = torch.cat([r[key][half * n // R:(half + 1) * n // R]
                             for r in ranks])
            assert torch.equal(got, single[key][half * n:(half + 1) * n]), key
    assert (single["dropout"] == 0).any()
    for r in ranks:
        assert torch.equal(r["generator"], single["generator"])


def test_local_batch_iterator_yields_the_rank_rows(runs):
    ranks, single = [r["loader"] for r in runs[0]], runs[1]["loader"]
    for key in ("images0", "labels0", "images1", "labels1"):
        assert single[key].shape[0] == 4
        assert torch.equal(torch.cat([r[key] for r in ranks]), single[key])


def test_evaluate_sums_the_matrix_over_ranks(runs):
    ranks, single = [r["eval"] for r in runs[0]], runs[1]["eval"]
    for r in ranks:
        assert r["cm"].dtype == torch.int64
        assert torch.equal(r["cm"], single["cm"])
        assert float(r["miou"]) == float(single["miou"])
    assert int(single["cm"].sum()) > 0


def test_local_shard_range_matches_jax(runs, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: R)
    for rank, r in enumerate(runs[0]):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        assert tuple(r["shard_range"]["range8"].tolist()) == \
            jdist.local_shard_range(8)
        assert bool(r["shard_range"]["raised"])
        with pytest.raises(ValueError):
            jdist.local_shard_range(3)
    assert tuple(runs[1]["shard_range"]["range8"].tolist()) == (0, 8)
    assert not bool(runs[1]["shard_range"]["raised"])
