"""The benchmark's plain reference (`perfbench/reference/`) against the
port's plain path (`e4s2024_torch` on the CPU, where every kernel wrapper
takes its plain version), on the same seeded weights and inputs, at
16^2-64^2 with narrow channels where a net allows it.

Tolerance: float outputs within 1e-5 of the reference's largest |value|
(the copies run the same float32 operations, so they agree to rounding);
label maps equal; uint8 images within 1 level at no more than 0.1% of
pixels.
"""

import copy

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import plain_kernels as pk
from perfbench.reference.arcface import ArcFaceBackbone
from perfbench.reference.blender import Blender
from perfbench.reference.bisenet import BiSeNet
from perfbench.reference.gcfsr import FaceInpainting
from perfbench.reference.gpen import GPENFullGenerator
from perfbench.reference.rgi import RGINet
from perfbench.reference.rrdb import RRDBNet
from perfbench.reference.stylegan2 import Discriminator

RTOL = 1e-5
SWAP = {"out_size": 64, "num_seg_cls": 12, "remaining_layer_idx": 7, "outer_dilation": 2,
        "keep_target_components": [0, 10, 4, 8, 7, 11], "regional_mode": "exact",
        "num_blend_levels": 10, "compute_dtype": "float32", "encoder_num_units": [1, 1, 1, 1]}
ZOO = {"enhancement_mode": "gpen", "ct_mode": "blender", "face_inpainting": True,
       "blend_up_ratio": 0.75, "gpen_size": 32, "gpen_channel_multiplier": 1, "gpen_narrow": 0.25,
       "blender_size": 16, "rrdb_num_feat": 16, "rrdb_num_block": 1, "rrdb_num_grow": 8,
       "gcfsr_size": 32}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def close(out, ref, rtol=RTOL):
    out, ref = torch.as_tensor(out).float(), torch.as_tensor(ref).float()
    assert out.shape == ref.shape
    scale = ref.abs().max().item()
    gap = (out - ref).abs().max().item()
    assert gap <= rtol * scale + 1e-7, f"max |diff| {gap} against {rtol} x {scale}"


def seeded_pair(ref_net_fn, port_net_fn, seed=7, overrides=None):
    """The reference net and the port's, on one seeded CPU state."""
    with torch.device("meta"):
        meta = ref_net_fn()
    state = weights.draw(weights.plan(meta, overrides), seed, "cpu")
    ref = ref_net_fn()
    ref.load_state_dict(state, strict=True)
    port = port_net_fn()
    port.load_state_dict(state, strict=True)
    return ref.eval(), port.eval()


def images(n, size, seed=3):
    from perfbench.traffic import smooth_images

    return smooth_images(n, size, seed, "cpu", block=8)


# ---------------------------------------------------------------- kernels


def test_plain_kernels_match_the_ports_plain_versions():
    from e4s2024_torch.ops import fused_act, modulate, upfirdn

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 17, 17, generator=g)
    bias = torch.randn(8, generator=g)
    close(pk.fused_leaky_relu(x, bias), fused_act.fused_leaky_relu(x, bias))
    k = pk.make_kernel([1, 3, 3, 1])
    close(pk.upsample_2x(x, k), upfirdn.upsample_2x(x, k))
    close(pk.downsample_2x(x, k), upfirdn.downsample_2x(x, k))
    close(pk.blur(x, k, (2, 1), upsample_factor=2), upfirdn.blur(x, k, (2, 1), 2))
    seg = torch.nn.functional.one_hot(torch.randint(0, 5, (2, 17, 17), generator=g), 5)
    seg = seg.permute(0, 3, 1, 2).float()
    scales = torch.randn(2, 5, 8, generator=g)
    close(pk.regional_scale(x, seg, scales), modulate.regional_scale(x, seg, scales))


def test_tally_counts_calls_and_least_bytes():
    x = torch.zeros(1, 4, 8, 8)
    with pk.tally() as t:
        pk.fused_leaky_relu(x, torch.zeros(4))
        pk.upsample_2x(x, pk.make_kernel([1, 3, 3, 1]))
    assert t.calls == {"fused_leaky_relu": 1, "upfirdn2d": 1}
    assert t.bytes["fused_leaky_relu"] == 2 * 4 * 64 * 4 + 4 * 4
    assert t.bytes["upfirdn2d"] == 4 * 64 * 4 + 4 * 256 * 4


# ---------------------------------------------------------------- nets


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_rgi_net_matches_the_port(mode):
    from e4s2024_torch.models.rgi import RGINet as PortRGINet

    kw = dict(num_seg_cls=12, out_size=64, remaining_layer_idx=7, encoder_num_units=(1, 1, 1, 1))
    ref, port = seeded_pair(lambda: RGINet(**kw), lambda: PortRGINet(**kw))
    img = images(1, 64).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    labels = torch.randint(0, 12, (1, 32, 32), generator=torch.Generator().manual_seed(1))
    onehot = torch.nn.functional.one_hot(labels, 12).permute(0, 3, 1, 2).float()
    with torch.no_grad():
        r_img, _ = ref(img, onehot, regional_mode=mode)
        p_img, _ = port(img, onehot, regional_mode=mode)
    close(r_img, p_img)


def test_bisenet_matches_the_port():
    from e4s2024_torch.models.bisenet import BiSeNet as PortBiSeNet

    ref, port = seeded_pair(BiSeNet, PortBiSeNet)
    x = images(1, 64).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        close(ref(x, aux=False, upsample=False)[0], port(x, aux=False, upsample=False)[0])


def test_discriminator_matches_the_port():
    from e4s2024_torch.models.stylegan2 import Discriminator as PortDiscriminator

    ref, port = seeded_pair(lambda: Discriminator(32, channel_multiplier=1),
                            lambda: PortDiscriminator(32, channel_multiplier=1))
    x = images(4, 32).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with torch.no_grad():
        close(ref(x), port(x))


def test_arcface_matches_the_port():
    from e4s2024_torch.models.arcface import ArcFaceBackbone as PortArcFace

    ref, port = seeded_pair(ArcFaceBackbone, PortArcFace)
    x = images(1, 112).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with torch.no_grad():
        for r, p in zip(ref(x, multi_scale=True), port(x, multi_scale=True)):
            close(r, p)


def test_gpen_matches_the_port():
    from e4s2024_torch.models.gpen import GPENFullGenerator as PortGPEN

    kw = dict(channel_multiplier=1, narrow=0.25)
    ref, port = seeded_pair(lambda: GPENFullGenerator(32, **kw), lambda: PortGPEN(32, **kw),
                            overrides={"*noise.weight": ("const", 0.1)})
    x = images(2, 32).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with torch.no_grad():
        close(ref(x)[0], port(x)[0])


def test_blender_matches_the_port():
    from e4s2024_torch.models.blender import Blender as PortBlender

    ref, port = seeded_pair(Blender, PortBlender)
    g = torch.Generator().manual_seed(2)
    a, t = torch.randn(1, 3, 32, 32, generator=g), torch.randn(1, 3, 32, 32, generator=g)
    ma, mt = (torch.randint(0, 19, (1, 32, 32), generator=g) for _ in range(2))
    with torch.no_grad():
        close(ref(a, t, ma, mt)[0], port(a, t, ma, mt)[0])


def test_rrdb_matches_the_port():
    from e4s2024_torch.models.rrdb import RRDBNet as PortRRDB

    ref, port = seeded_pair(lambda: RRDBNet(16, 1, 8), lambda: PortRRDB(16, 1, 8))
    x = images(1, 16).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        close(ref(x), port(x))


def test_gcfsr_matches_the_port():
    from e4s2024_torch.models.gcfsr import FaceInpainting as PortGCFSR

    ref, port = seeded_pair(lambda: FaceInpainting(32), lambda: PortGCFSR(32))
    x = torch.rand(2, 4, 32, 32, generator=torch.Generator().manual_seed(4))
    cond = torch.tensor([[0.2], [0.4]])
    with torch.no_grad():
        close(ref(x, cond)[0], port(x, cond)[0])


# ---------------------------------------------------------------- pipelines


def _pairs(batch, seed=5):
    imgs = images(2 * batch, 64, seed)
    return imgs[:batch].numpy(), imgs[batch:].numpy()


def test_aligned_swap_matches_the_port():
    from perfbench.pairs_driver import face_swapper
    from perfbench.reference.swap import Swapper

    meta = Swapper(SWAP, "meta")
    state = weights.seeded_state(meta.nets(), 11, "cpu")
    ref = Swapper(SWAP, "meta")
    ref.load(state, "cpu")
    port = face_swapper(SWAP, copy.deepcopy(state), "cpu")
    d, t = _pairs(1)
    out = port.swap_aligned(d, t)
    r = ref.swap_aligned(torch.from_numpy(d), torch.from_numpy(t))
    assert torch.equal(out["swapped_mask"], r["swapped_mask"])
    close(out["swapped_style_vectors"], r["swapped_style_vectors"])
    diff = (out["image"].int() - r["image"].int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3


def test_zoo_swap_matches_the_port(monkeypatch):
    from e4s2024_torch.models.blender import BlenderRecolorer
    from perfbench.drivers.swap_batch import Driver
    from perfbench.harness import Context
    from perfbench.reference.zoo import ZooSwapper

    monkeypatch.setattr(BlenderRecolorer, "size", ZOO["blender_size"])
    cfg = {"swap": SWAP, "zoo": ZOO}
    meta = ZooSwapper(cfg, "meta")
    overrides = {"gpen": {"*noise.weight": ("const", 0.1)}}
    state = weights.seeded_state(meta.nets(), 13, "cpu", overrides)
    ref = ZooSwapper(cfg, "meta")
    ref.load(state, "cpu")
    ctx = Context(config=cfg, traffic={}, workload={}, seed=13,
                  device=torch.device("cpu"))
    port = Driver(ctx).build_program(copy.deepcopy(state))
    d, t = _pairs(2)
    out = port.swap_batch(d, t)
    r = ref.swap_batch(torch.from_numpy(d), torch.from_numpy(t))["image"]
    diff = (out.int() - r.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3


def test_seeded_weights_repeat_and_follow_the_seed():
    with torch.device("meta"):
        net = RRDBNet(16, 1, 8)
    plan = weights.plan(net)
    a = weights.draw(plan, 2 ** 31 + 5, "cpu")
    b = weights.draw(plan, 2 ** 31 + 5, "cpu")
    c = weights.draw(plan, 2 ** 31 + 6, "cpu")
    w = "conv_first.weight"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
    bound = 1 / np.sqrt(3 * 9)
    assert a[w].abs().max() <= bound and a[w].abs().max() > 0.9 * bound
