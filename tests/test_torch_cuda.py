"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version, bitwise, through the public wrappers, and the
launch counters.  Imports no JAX, so it runs on a GPU host without the
reference; without CUDA every test skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.spatial_index import (  # noqa: E402
    SCALE_BLOCK,
    block_metadata_np,
    quantize_amps_np,
)
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.geo_score import ops as pg  # noqa: E402
from repro_torch.kernels.geo_score.ref import geo_score_toeprints_ref  # noqa: E402
from repro_torch.kernels.sweep_score import ops as ps  # noqa: E402
from repro_torch.kernels.sweep_score import ref as psr  # noqa: E402

INVALID = 2**31 - 1
QR2 = np.array([[0.2, 0.2, 0.6, 0.6], [0.5, 0.5, 0.9, 0.9]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, dev):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _rects(rng, n):
    lo = rng.uniform(0, 0.9, (n, 2)).astype(np.float32)
    hi = lo + rng.uniform(0.005, 0.2, (n, 2)).astype(np.float32)
    return np.concatenate([lo, np.minimum(hi, 1.0)], axis=1)


def _store(rng, T, mode):
    lo = rng.uniform(0, 0.9, (T, 2)).astype(np.float32)
    wh = rng.uniform(0.01, 0.08, (T, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + wh], axis=1).astype(np.float32)
    amps = rng.uniform(-0.2, 1.0, T).astype(np.float32)
    if mode == "f32":
        return rects, amps, None, amps
    rects = rects.astype(np.float16)
    if mode == "f16":
        return rects, amps.astype(np.float16), None, amps.astype(np.float16).astype(np.float32)
    store, scale = quantize_amps_np(amps)
    return rects, store, scale, store.astype(np.float32) * np.repeat(scale, SCALE_BLOCK)[:T]


def _sweeps(rng, T, budget, k):
    ss = np.sort(rng.integers(0, T, k)).astype(np.int32)
    ee = np.minimum(ss + rng.integers(1, budget + 500, k), T).astype(np.int32)
    ss[k // 2] = INVALID
    ee[k // 2] = INVALID
    return ss, ee


@pytest.mark.cuda
def test_geo_score_kernel_bitwise_on_card(cuda):
    rng = np.random.default_rng(5)
    r = np.stack([_rects(rng, 3000) for _ in range(4)])
    a = rng.uniform(0, 1, (4, 3000)).astype(np.float32)
    qr = np.stack([_rects(rng, 3) for _ in range(4)])
    qa = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    args = [_t(x, cuda) for x in (r, a, qr, qa)]
    reset_launch_counts()
    got = pg.geo_score_toeprints(*args)
    assert launch_counts()["geo_score"] == 1
    want = geo_score_toeprints_ref(*args[:2], *pg.pad_query(*args[2:]))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
@pytest.mark.parametrize("bs", [128, 256, 512, 1024])
def test_sweep_kernels_bitwise_on_card(cuda, mode, bs):
    rng = np.random.default_rng(bs)
    T, budget = 20000, 2048
    rects, store, scale, dec = _store(rng, T, mode)
    meta = [_t(x, cuda) for x in block_metadata_np(rects.astype(np.float32), dec, bs)]
    sw = [_sweeps(rng, T, budget, 4) for _ in range(3)]
    q = [_t(x, cuda) for x in (np.stack([s for s, _ in sw]), np.stack([e for _, e in sw]),
                              np.stack([QR2] * 3), np.ones((3, 2), np.float32))]
    base = [_t(x, cuda) for x in (rects, store)]
    sc = _t(scale, cuda)
    reset_launch_counts()
    got = ps.sweep_score(*base, *q, budget, tp_amp_scale=sc)
    got_p = ps.sweep_score_pruned(*base, *meta, *q, budget, 1024, bs, 0.001, tp_amp_scale=sc)
    assert launch_counts() == {"sweep_score": 1, "geo_score": 0, "sweep_score_pruned": 1}
    want = psr.sweep_score_ref(*base, *q, budget, tp_amp_scale=sc)
    want_p = psr.sweep_score_pruned_ref(*base, *meta, *q, budget, 1024, bs, 0.001, tp_amp_scale=sc)
    torch.cuda.synchronize()
    for x, y in zip((*got, *got_p), (*want, *want_p)):
        assert torch.equal(x, y)
