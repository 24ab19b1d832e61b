"""K7's bounded scan: the rows and per-row column spans of each level's
16 x 16 window that the tap visits (csrc/texture.cuh ewa_row_span) hold
every texel the exact EWA filter weighs.

The plain twin of the kernel's span arithmetic, ops/texture.ewa_row_spans
(float32, expression for expression), is run through the plain version's
counting hook (ops/texture.ScanCounter under `work["ewa_scan"]`, fed by
scene/mipmap.ewa_level with the ellipse, its window and the texels of
non-zero weight): on 2^16 seeded lookups (walk_ab.tex_queries, chip_smoke.py
12a's kind) and walk_ab.k7_footprints' adversarial ones (thin diagonal
ellipses, radii clamped at the window's 7, the determinant clamped at
1e-12, coefficients past float32's range, infinite st, degenerate
footprints) under the three wraps, no weighed texel lies outside the
spans; and, calling mipmap.ewa_level on NaN and infinite axes, the spans
are the whole window wherever the coefficients are not finite.  No JAX
here: the plain tap is held to the JAX package in tests/test_torch_texture.py.
"""

import numpy as np
import pytest
import torch

from rs_ray_toy_tpu_torch.ops import texture as tex_ops
from rs_ray_toy_tpu_torch.scene import mipmap
from rs_ray_toy_tpu_torch.walk_ab import k7_footprints, k7_pyramid, tex_queries

# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))
N_SEEDED = 1 << 16  # split over the three wraps
N_ADVERSARIAL = 1 << 10


@pytest.fixture(scope="module")
def pyramids():
    return {wrap: k7_pyramid(wrap, "cpu") for wrap in
            (mipmap.WRAP_REPEAT, mipmap.WRAP_BLACK, mipmap.WRAP_CLAMP)}


@pytest.mark.parametrize("wrap", ["repeat", "black", "clamp"])
def test_spans_hold_every_weighed_texel(pyramids, wrap):
    w = mipmap.WRAP_NAMES[wrap]
    seeded = tex_queries(N_SEEDED // 3 + 1, 40 + w, "cpu")
    adversarial = k7_footprints(N_ADVERSARIAL, 50 + w, "cpu")
    queries = [torch.cat(pair) for pair in zip(seeded, adversarial)]
    counter = tex_ops.ScanCounter()
    work = {"ewa_scan": counter}
    tex_ops.tex_lookup_reference(pyramids[w], *queries, work)
    found = counter.summary()
    assert found["uncovered"] == 0
    # every texel the tap weighs is visited, and the spans are a small share
    # of the windows on the seeded lookups
    assert found["weighed"] <= found["scanned"] < found["window"] / 4
    assert found["lookups"] > N_SEEDED // 4


def _level_case(axes, st=(0.3, 0.6)):
    """One lookup a row of `axes` (d0s, d0t, d1s, d1t) at st, on level 0."""
    d = torch.tensor(axes, dtype=torch.float32)
    s = torch.full((d.shape[0],), st[0], dtype=torch.float32)
    t = torch.full((d.shape[0],), st[1], dtype=torch.float32)
    return s, t, d.unbind(1)


@pytest.mark.parametrize("wrap", ["repeat", "black", "clamp"])
def test_non_finite_coefficients_scan_the_whole_window(pyramids, wrap):
    pyr = pyramids[mipmap.WRAP_NAMES[wrap]]
    nan, inf = float("nan"), float("inf")
    px = 1.0 / pyr.dims[0][1]  # a texel of level 0, in uv
    axes = [(nan, 0.0, 0.0, 0.01), (0.01, inf, 0.0, 0.01), (-inf, 0.0, 0.0, nan),
            (1e30, 1e30, -1e30, 1e30), (1.5 * px, 1.5 * px, -1e-3 * px, 1e-3 * px)]
    s, t, d = _level_case(axes)
    seen = {}

    def hook(live, a, b, c, s_, t_, s0, t0, weighed):
        j0, j1 = tex_ops.ewa_row_spans(a, b, c, s_, t_, s0, t0)
        seen.update(finite=torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c),
                    j0=j0, j1=j1, weighed=weighed)

    level = torch.zeros((len(axes),), dtype=torch.int64)
    live = torch.ones((len(axes),), dtype=torch.bool)
    mipmap.ewa_level(pyr, level, s, t, *d, live, {"ewa_scan": hook})
    whole = ~seen["finite"]
    assert bool(whole[:4].all()) and not bool(whole[4])
    assert bool((seen["j0"][whole] == 0).all() and (seen["j1"][whole] == 15).all())
    # the finite thin ellipse: a few rows, each a short span holding its texels
    rows = seen["j1"][4] >= seen["j0"][4]
    assert 0 < int(rows.sum()) < 16
    col = torch.arange(16)
    inside = (col >= seen["j0"][4][:, None]) & (col <= seen["j1"][4][:, None])
    assert bool(seen["weighed"][4].any()) and not bool((seen["weighed"][4] & ~inside).any())


def test_span_twin_is_float32_and_symmetric():
    """A circle of radius 3 texels centred on a texel: every row of the
    window within the circle is visited, symmetric about the centre, the
    rows past it skipped, each span one texel wider than its chord."""
    a = torch.tensor([1.0 / 9.0], dtype=torch.float32)
    b = torch.zeros_like(a)
    s = torch.tensor([8.0], dtype=torch.float32)
    t = torch.tensor([8.0], dtype=torch.float32)
    s0 = torch.tensor([1], dtype=torch.int64)  # ceil(8 - 7)
    t0 = torch.tensor([1], dtype=torch.int64)
    j0, j1 = tex_ops.ewa_row_spans(a, b, a, s, t, s0, t0)
    assert j0.dtype == torch.int64 and j0.shape == (1, 16)
    tt = np.arange(16) + 1 - 8.0
    for i, dy in enumerate(tt):
        if abs(dy) > 3.0 + 1e-3:
            assert int(j1[0, i]) < int(j0[0, i]), f"row {i} at tt {dy} kept"
            continue
        half = np.sqrt(max(9.0 - dy * dy, 0.0))
        assert int(j0[0, i]) == max(int(np.ceil(7 - half - 1 - 1e-3)), 0)
        assert int(j1[0, i]) == min(int(np.floor(7 + half + 1 + 1e-3)), 15)
