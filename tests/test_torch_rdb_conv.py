"""Kernel K7's plain side on the CPU (`ops/rdb_conv.py`, `models/rrdb.py`).

The dense-buffer data flow that the kernel path takes (each `rdb_conv`
on the CPU is `rdb_conv_plain`) against the plain modules; the
tf32 split of the weights and their packed layout as the kernel reads it;
and the dispatch rule, which keeps every case but a float32 net of the
published widths on a card on the plain path. Nets at 16^2, B=2.
"""

import pytest
import torch

from e4s2024_torch import kernels
from e4s2024_torch.models.rrdb import RRDBNet, RealESRGANUpscaler, dense_block, dense_rrdb
from e4s2024_torch.ops import rdb_conv as rc
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)

NF, NG = 64, 32
WIDTH = NF + 4 * NG


def _net(num_feat=NF, num_block=1, num_grow=NG, seed=0):
    torch.manual_seed(seed)
    net = RRDBNet(num_feat, num_block, num_grow).eval().requires_grad_(False)
    with torch.no_grad():  # biases away from zero, so that every add shows
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.1)
    return net


def _block_case(net, x):
    """One ResidualDenseBlock: conv1-4 with bias + LeakyReLU into the
    buffer, conv5 with the block's residual into the next buffer."""
    rdb = net.body[0].rdb1
    src = torch.zeros(*x.shape[:3], WIDTH)
    src[..., :NF] = x
    dst = torch.full((*x.shape[:3], WIDTH), float("nan"))
    dense_block(rdb, src, dst)
    return dst[..., :NF], rdb(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _rrdb_case(net, x):
    """One RRDB through three buffers, the third block's conv5 also adding
    the RRDB's residual in place."""
    bufs = [torch.full((*x.shape[:3], WIDTH), float("nan")) for _ in range(3)]
    bufs[0][..., :NF] = x
    dense_rrdb(net.body[0], bufs)
    return bufs[0][..., :NF], net.body[0](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _net_case(net, x):
    """The whole net: conv_body with `+ feat`, the tail's folded upsamples."""
    img = x[..., :3].sigmoid()
    want = net(img.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    return net.dense_forward(img), want


@pytest.mark.parametrize("case", [_block_case, _rrdb_case, _net_case],
                         ids=["dense_block", "rrdb", "net"])
def test_dense_flow_matches_plain_modules(case):
    net = _net()
    x = torch.randn(2, 16, 16, NF, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = case(net, x)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_tf32_split_and_packing():
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(64, 96, 3, 3, generator=gen) * torch.logspace(-6, 3, 96)[None, :, None, None]
    hi, lo = rc.split_tf32(w)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & ((1 << rc.TF32_DROP) - 1)).any()
    assert float(((hi + lo - w).abs() / w.abs()).max()) <= 2.0 ** -22
    assert torch.equal(rc.round_tf32(hi), hi)

    # the packed slabs read back as the kernel reads them: slab c * 9 + tap,
    # half, output group G, k core kc, output row r, float f holds output
    # 8 G + r at k position 4 kc + f, whose channel is 32 c + k_order
    packed = rc.pack_weights(w)
    assert packed.shape == (3 * 9, 2, 8, 8, 8, 4)
    back = torch.empty(2, 64, 96, 9)
    order = rc.k_order()
    for slab in range(packed.shape[0]):
        c, tap = divmod(slab, 9)
        for half in range(2):
            b = packed[slab, half].permute(0, 2, 1, 3).reshape(64, 32)  # (n, position)
            back[half, :, 32 * c + order, tap] = b
    assert torch.equal(back[0], hi.reshape(64, 96, 9))
    assert torch.equal(back[1], lo.reshape(64, 96, 9))
    assert sorted(order.tolist()) == list(range(32))


@pytest.mark.parametrize("widths, dtype, on_card", [
    ((NF, NG), torch.float32, False), ((16, 8), torch.float32, False),
    ((16, 8), torch.float32, True), ((NF, NG), torch.float64, True),
    ((NF, NG), torch.float32, True)], ids=["cpu", "cpu-16", "card-16", "card-f64", "card"])
def test_dispatch_keeps_the_plain_path(monkeypatch, widths, dtype, on_card):
    """On the CPU and, on a card, at other widths or types the net takes
    `forward` between two permutes, launches nothing and gives today's
    output; only float32 at 64 / 32 on a card asks for K7 (checked here
    through `uses_k7` alone: this host has no card)."""
    net = _net(widths[0], 1, widths[1]).to(dtype)
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(3)).to(dtype)
    if on_card:
        monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    wants_k7 = on_card and widths == (NF, NG) and dtype == torch.float32
    assert net.uses_k7(x) == wants_k7
    if wants_k7:
        return
    before = rc.rdb_conv.launches
    with torch.no_grad():
        got = net.forward_nhwc(x)
        want = net(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    assert rc.rdb_conv.launches == before
    if not on_card and widths == (NF, NG):
        up = RealESRGANUpscaler(net.state_dict(), num_feat=NF, num_block=1, num_grow=NG,
                                device="cpu")
        assert torch.equal(up.forward(x), want)
