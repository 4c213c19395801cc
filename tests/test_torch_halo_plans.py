"""K19's launch plans on the CPU (``ops/halo.py``, ``csrc/halo.cu``): the
walk rule's Python mirror (``halo_walk``) on the tile and window views
``chip_smoke.py`` drives on the card, the parts table's split into
launches of at most eight parts, and the batched plain path (several
parts in one call) against one plain call per part, bit for bit, for
every halo source on both axes and in fp32 and bf16."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import K19_VIEWS, _k19_views
from pytorch_wavelets_tpu_torch.ops import halo

CSRC = Path(__file__).resolve().parents[1] / "pytorch_wavelets_tpu_torch" \
    / "csrc" / "halo.cu"
SOURCES = [("recv", "recv"), ("flip", "zero"), ("zero", "flip"),
           ("flip", "recv"), ("recv", "flip"), ("zero", "zero")]


def _rand(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32)).to(dtype)


def _window(x, axis, left, right, pitch=1, offset=0):
    """A window for tile ``x`` as a slice of a wider one: ``offset``
    samples into it along W, its rows ``pitch``-aligned."""
    shape = halo.block_shape(x, axis, left + x.shape[axis] + right)
    wide = list(shape)
    wide[3] = -(-(wide[3] + offset) // pitch) * pitch
    return torch.empty(wide, dtype=x.dtype).narrow(3, offset, shape[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
def test_walk_rule_vector(dtype, axis):
    """Tiles and windows at unit stride along W take the vector walk,
    wherever their rows start: a contiguous tile, every other row, a tile
    one column short of its rows (an odd length along W), one at an
    element offset, rows at a pitch off the 16-byte lines (fp32 rows of 7
    samples, bf16 windows of 148), a window sliced from a wider one on
    the lines and one sample off them, and the windows of two parts side
    by side, the second 8 bytes into a line (the inverse's [lo | hi]
    merges)."""
    base = _rand((2, 4, 10, 16), 0, dtype)
    for kind in ("contiguous", "rows", "narrow", "offset"):
        x = _k19_views(base, kind)
        assert halo.halo_walk(x) == "vector", kind
        for offset in (0, 1):
            assert halo.halo_walk(x, _window(x, axis, 3, 5, 16, offset)) \
                == "vector", (kind, offset)
    x = _k19_views(base, "contiguous")
    assert halo.halo_walk(x, _window(x, axis, 3, 5)) == "vector"
    odd = _rand((2, 4, 10, 7), 2, dtype)
    assert halo.halo_walk(odd, _window(odd, axis, 3, 5)) == "vector"
    assert halo.halo_walk(_rand((2, 3, 8, 148), 3, dtype)) == "vector"
    gw = _rand((2, 4, 16, 68), 1, dtype)
    assert halo.halo_walk(gw.narrow(3, 0, 34), gw.narrow(3, 34, 34)) \
        == "vector"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
def test_walk_rule_strided(dtype, axis):
    """A transposed tile, a strided slice along W, and a window laid out
    with H innermost take the strided walk, whatever the other operand;
    a dim of one sample along W keeps the vector walk."""
    base = _rand((2, 4, 10, 16), 0, dtype)
    for kind in ("transposed", "strided"):
        x = _k19_views(base, kind)
        assert halo.halo_walk(x) == "strided", kind
        assert halo.halo_walk(x, _window(x, axis, 3, 5)) == "strided", kind
    x = _k19_views(base, "contiguous")
    assert halo.halo_walk(x, _window(x, axis, 3, 5)
                          .transpose(2, 3).contiguous().transpose(2, 3)) \
        == "strided"
    assert halo.halo_walk(base.transpose(2, 3)[..., :1]) == "vector"
    assert set(K19_VIEWS) == {"contiguous", "transposed", "strided",
                              "offset", "rows", "narrow"}


def test_parts_table_splits_at_eight():
    """A launch takes at most eight parts (the C table's size): more are
    split into launches of at most eight, in order."""
    m = re.search(r"constexpr int MAX_PARTS = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == halo.MAX_PARTS == 8
    assert halo.part_groups(1) == [(0, 1)]
    assert halo.part_groups(8) == [(0, 8)]
    assert halo.part_groups(10) == [(0, 8), (8, 10)]
    assert halo.part_groups(17) == [(0, 8), (8, 16), (16, 17)]
    assert all(hi - lo <= 8 for lo, hi in halo.part_groups(100))


def _parts(axis, lengths, dtype, seed):
    parts = []
    for i, L in enumerate(lengths):
        shape = [2, 3, 5, 6]
        shape[axis] = L
        parts.append(_rand(shape, seed + i, dtype))
    return parts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("lsrc,rsrc", SOURCES)
def test_batched_plain_equals_per_part(dtype, axis, lsrc, rsrc):
    """pack, assemble and fold over ten parts of lengths 4-9 (two
    launches' worth) in one call equal one call per part, bit for bit:
    blocks back to back, windows side by side along the axis."""
    lengths = [4 + i % 6 for i in range(10)]
    parts = _parts(axis, lengths, dtype, 10)
    left, right = 3, 2
    per = parts[0].numel() // parts[0].shape[axis]
    n = per * len(parts)
    tail, head = parts[0].new_empty(n * left), parts[0].new_empty(n * right)
    halo.halo_pack(parts, axis, left, right, tail, head)
    recv_l, recv_r = _rand((n * left,), 1, dtype), _rand((n * right,), 2,
                                                         dtype)
    wshape = halo.block_shape(parts[0], axis,
                              sum(lengths) + len(parts) * (left + right))
    win = halo.halo_assemble(parts, axis, left, right, lsrc, rsrc, recv_l,
                             recv_r, parts[0].new_empty(wshape))
    gw = _rand(wshape, 3, dtype)
    from_l, from_r = _rand((n * right,), 4, dtype), _rand((n * left,), 5,
                                                          dtype)
    dxs = halo.halo_fold(gw, axis, left, right, lsrc, rsrc, from_l, from_r,
                         lengths)
    assert isinstance(dxs, tuple) and len(dxs) == len(parts)
    ofs = 0
    for i, p in enumerate(parts):
        w = left + p.shape[axis] + right
        t1, h1 = p.new_empty(per * left), p.new_empty(per * right)
        halo.halo_pack_plain(p, axis, left, right, t1, h1)
        assert torch.equal(tail[i * per * left:(i + 1) * per * left], t1)
        assert torch.equal(head[i * per * right:(i + 1) * per * right], h1)
        w1 = halo.halo_assemble_plain(
            p, axis, left, right, lsrc, rsrc,
            recv_l[i * per * left:(i + 1) * per * left],
            recv_r[i * per * right:(i + 1) * per * right],
            p.new_empty(halo.block_shape(p, axis, w)))
        assert torch.equal(win.narrow(axis, ofs, w), w1)
        d1 = halo.halo_fold_plain(
            gw.narrow(axis, ofs, w), axis, left, right, lsrc, rsrc,
            from_l[i * per * right:(i + 1) * per * right],
            from_r[i * per * left:(i + 1) * per * left])
        assert torch.equal(dxs[i], d1)
        ofs += w


def test_parts_must_share_their_shape():
    """Parts of one launch differ only along the axis."""
    a, b = torch.zeros(2, 3, 5, 6), torch.zeros(2, 4, 5, 6)
    with pytest.raises(ValueError, match="differ"):
        halo.halo_pack([a, b], 3, 1, 1, torch.empty(66), torch.empty(66))
    with pytest.raises(ValueError, match="does not fit"):
        halo.halo_fold(torch.zeros(2, 3, 5, 20), 3, 1, 1, "zero", "zero",
                       None, None, [6, 6])
