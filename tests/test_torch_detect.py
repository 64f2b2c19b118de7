"""The port's detection stack (e4s2024_torch.models.retinaface, models.fan,
pipelines.detect, the RetinaFace / FAN converters and the checkpoint
loader) against the JAX package's, on the CPU.

Small nets, as tests/test_detect.py builds them: RetinaFace MobileNet-0.25
at det_size 160 (ResNet-50 at 64^2), FAN with 1 module, 32 features, depth
2 at resolution 64. Weights come from numpy seeds.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_fan, convert_retinaface
from e4s2024_tpu.models.fan import heatmaps_to_landmarks as j_heatmaps_to_landmarks
from e4s2024_tpu.models.retinaface import CFG_MNET as J_CFG_MNET
from e4s2024_tpu.models.retinaface import CFG_RE50 as J_CFG_RE50
from e4s2024_tpu.models.retinaface import RetinaFace as JRetinaFace
from e4s2024_tpu.models.retinaface import decode_boxes as j_decode_boxes
from e4s2024_tpu.models.retinaface import decode_landms as j_decode_landms
from e4s2024_tpu.models.retinaface import generate_priors as j_generate_priors
from e4s2024_tpu.pipelines import detect as jdetect

from e4s2024_torch.convert import (
    fan_state_dict_from_jax, fold_bgr_mean_into_stem, load_reference_checkpoint,
    retinaface_state_dict_from_jax)
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.fan import FAN, heatmaps_to_landmarks
from e4s2024_torch.models.retinaface import (
    CFG_MNET, CFG_RE50, RetinaFace, decode_boxes, decode_landms, generate_priors)
from e4s2024_torch.pipelines import detect
from tests.test_torch_criterion import two_threads  # noqa: F401

DET, FAN_CFG = 160, dict(num_modules=1, features=32, depth=2)
FAN_RES = 64


def reference_state_dict(make, seed: int) -> dict:
    """A seeded state dict in the reference's names for the net `make()`
    builds (convolutions LeCun normal, BN statistics and affines drawn away
    from the identity), as a reference checkpoint would hold it: unfolded,
    BGR input."""
    with torch.device("meta"):  # names and shapes only
        model = make()
    rng = np.random.default_rng(seed)
    out = {}
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, torch.nn.Conv2d):
            w = rng.standard_normal(m.weight.shape) / np.sqrt(m.weight[0].numel())
            out[f"{p}weight"] = torch.tensor(w, dtype=torch.float32)
            if m.bias is not None:
                out[f"{p}bias"] = torch.tensor(0.1 * rng.standard_normal(m.bias.shape),
                                               dtype=torch.float32)
        elif isinstance(m, FrozenBatchNorm):
            c = m.weight.shape[0]
            for key, v in (("weight", 1 + 0.1 * rng.standard_normal(c)),
                           ("bias", 0.1 * rng.standard_normal(c)),
                           ("running_mean", 0.1 * rng.standard_normal(c)),
                           ("running_var", rng.uniform(0.5, 1.5, c))):
                out[f"{p}{key}"] = torch.tensor(v, dtype=torch.float32)
    return out


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _rgb(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """Reference-style (unfolded) state dicts, the JAX params that
    convert_retinaface / convert_fan make of them, and the port's modules
    loaded through the inverse converters."""
    out = {}
    for cfg, jcfg in ((CFG_MNET, J_CFG_MNET), (CFG_RE50, J_CFG_RE50)):
        ref = reference_state_dict(lambda: RetinaFace(cfg), 1 if cfg is CFG_MNET else 2)
        params = convert_retinaface(_np(ref), jcfg)
        net = RetinaFace(cfg).eval()
        net.load_state_dict(retinaface_state_dict_from_jax(params, cfg))
        out[cfg["backbone"]] = (ref, params, net)
    return out


def test_priors_and_decode_match_jax():
    np.testing.assert_array_equal(generate_priors((100, 160), CFG_MNET),
                                  j_generate_priors((100, 160), J_CFG_MNET))
    rng = np.random.default_rng(1)
    priors = np.abs(rng.standard_normal((2, 50, 4))).astype(np.float32) * 0.2 + 0.1
    loc = rng.standard_normal((2, 50, 4)).astype(np.float32)
    pre = rng.standard_normal((2, 50, 10)).astype(np.float32)
    got = decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors)).numpy()
    want = np.asarray(j_decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
    # the same float32 operations in the same order; exp may differ by an
    # ulp, which the corner's subtraction carries as an absolute error
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)
    np.testing.assert_array_equal(
        decode_landms(torch.from_numpy(pre), torch.from_numpy(priors)).numpy(),
        np.asarray(j_decode_landms(jnp.asarray(pre), jnp.asarray(priors))))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_pairwise_iou_matches_jax(offset):
    rng = np.random.default_rng(2)
    tl = rng.random((30, 2)).astype(np.float32) * 50
    boxes = np.concatenate([tl, tl + rng.random((30, 2)).astype(np.float32) * 40 + 1], 1)
    boxes[5] = boxes[4]  # identical pair
    got = detect.pairwise_iou(torch.from_numpy(boxes), offset).numpy()
    want = np.asarray(jdetect.pairwise_iou(jnp.asarray(boxes), offset))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[4, 5] == pytest.approx(1.0)


def test_nms_fixed_matches_jax_with_ties():
    """Clusters of overlapping boxes with tied scores: the stable top-k and
    the greedy pass pick the same indices and keep the same rows as
    lax.top_k and the JAX fori_loop."""
    rng = np.random.default_rng(3)
    centres = rng.random((6, 2)) * 200
    boxes = []
    for c in centres:
        for _ in range(8):
            tl = c + rng.standard_normal(2) * 4
            boxes.append(np.concatenate([tl, tl + 30 + rng.random(2) * 6]))
    boxes = np.asarray(boxes, np.float32)
    scores = np.round(rng.random(len(boxes)) * 4) / 4  # five values: many ties
    scores = scores.astype(np.float32)
    for k in (48, 20):
        b, sc, keep, idx = detect.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                                            k, 0.4)
        jb, jsc, jkeep, jidx = jax.jit(lambda bb, ss: jdetect.nms_fixed(bb, ss, k, 0.4))(
            jnp.asarray(boxes), jnp.asarray(scores))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        assert 1 < int(keep.sum()) < k


def test_pad_to_chunk():
    a = np.arange(10).reshape(5, 2)
    for x in (a, torch.from_numpy(a)):
        got, n = detect.pad_to_chunk(x, 4)
        want, jn = jdetect.pad_to_chunk(a, 4)
        assert n == jn == 5
        np.testing.assert_array_equal(np.asarray(got), want)
    assert detect.pad_to_chunk(a, 5)[0] is a


@pytest.mark.parametrize("backbone,size", [("mobilenet", DET), ("resnet50", 64)])
def test_retinaface_matches_jax(nets, backbone, size):
    """Through convert_retinaface -> retinaface_state_dict_from_jax, on RGB
    [0, 255] input: loc, conf, landms within 1e-4 of their spread."""
    _, params, net = nets[backbone]
    x = _rgb(4, (1, size, size, 3))
    cfg = CFG_MNET if backbone == "mobilenet" else CFG_RE50
    jm = JRetinaFace(backbone=backbone, out_channel=cfg["out_channel"])
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * (w.max() - w.min())


@pytest.mark.parametrize("backbone", ["mobilenet", "resnet50"])
def test_folded_loader_matches_convert_retinaface(nets, backbone, tmp_path):
    """A reference checkpoint (DDP prefix, BN counters) read by
    load_reference_checkpoint and folded for RGB input equals what
    convert_retinaface makes of it, key by key."""
    ref, params, _ = nets[backbone]
    cfg = CFG_MNET if backbone == "mobilenet" else CFG_RE50
    saved = {f"module.{k}": v for k, v in ref.items()}
    saved["module.body.bn1.num_batches_tracked" if backbone == "resnet50"
          else "module.body.stage1.0.1.num_batches_tracked"] = torch.tensor(7)
    torch.save(saved, tmp_path / "det.pth")
    got = fold_bgr_mean_into_stem(load_reference_checkpoint(str(tmp_path / "det.pth")), cfg)
    want = retinaface_state_dict_from_jax(params, cfg)
    stem, stem_bn = (("body.stage1.0.0", "body.stage1.0.1") if backbone == "mobilenet"
                     else ("body.conv1", "body.bn1"))
    assert set(got) == set(want)
    for k in set(want) - {f"{stem_bn}.running_mean"}:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got[f"{stem}.weight"].numpy(),
                                  ref[f"{stem}.weight"].flip(1).numpy())
    # the stem BN's mean gains conv(W, mean), a float32 sum on both sides in
    # its own order: within 1e-6 of the sum of the terms' magnitudes
    mag = np.einsum("oihw,i->o", np.abs(ref[f"{stem}.weight"].numpy()), [104.0, 117.0, 123.0])
    diff = np.abs(got[f"{stem_bn}.running_mean"].numpy() - want[f"{stem_bn}.running_mean"].numpy())
    assert (diff <= 1e-6 * mag).all(), (diff / mag).max()


def test_bgr_fold_is_exact_inside_the_stem_output(nets, capsys):
    """The fold equals the reference's BGR - mean input on the stem output
    except its first row and column, where the reference's zero padding of
    (BGR - mean) is not the fold's zero padding of the raw image. Prints
    how far that moves the detector's conf and loc at det_size 160 (the
    size recorded as a reference caveat)."""
    ref, _, folded = nets["mobilenet"]
    unfolded = RetinaFace(CFG_MNET).eval()
    unfolded.load_state_dict(ref)
    rgb = torch.from_numpy(_rgb(5, (1, DET, DET, 3)).transpose(0, 3, 1, 2).copy())
    bgr_minus_mean = rgb.flip(1) - torch.tensor([104.0, 117.0, 123.0]).view(1, 3, 1, 1)
    with torch.no_grad():
        s_fold = folded.body.stage1[0](rgb)
        s_ref = unfolded.body.stage1[0](bgr_minus_mean)
        spread = float(s_ref.max() - s_ref.min())
        inner = (s_fold - s_ref)[..., 1:, 1:].abs().max()
        border = (s_fold - s_ref).abs().max()
        assert inner <= 1e-5 * spread
        assert border > 1e-2 * spread  # the padded border does differ
        (loc_f, conf_f, _), (loc_r, conf_r, _) = folded(rgb), unfolded(bgr_minus_mean)
    with capsys.disabled():
        print(f"\n[bgr fold, mobilenet, det_size {DET}] max|d conf| "
              f"{float((conf_f - conf_r).abs().max()):.6g}, max|d loc| "
              f"{float((loc_f - loc_r).abs().max()):.6g} (loc spread "
              f"{float(loc_r.max() - loc_r.min()):.6g})")


def test_fan_matches_jax_and_round_trips():
    """Through convert_fan -> fan_state_dict_from_jax (the state dict comes
    back unchanged): the heatmaps within 1e-4 of their spread."""
    jm = jdetect.FAN(**FAN_CFG)
    ref = reference_state_dict(lambda: FAN(**FAN_CFG), 6)
    params = convert_fan(_np(ref), FAN_CFG["num_modules"], FAN_CFG["depth"])
    sd = fan_state_dict_from_jax(params, FAN_CFG["num_modules"], FAN_CFG["depth"])
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k].numpy(), err_msg=k)
    net = FAN(**FAN_CFG).eval()
    net.load_state_dict(sd)
    x = np.random.default_rng(7).random((2, FAN_RES, FAN_RES, 3)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * (w.max() - w.min())


def test_heatmaps_to_landmarks_matches_jax():
    rng = np.random.default_rng(8)
    hm = rng.random((2, 5, 16, 16)).astype(np.float32)
    hm[0, 0, 5, 7], hm[0, 0, 5, 8], hm[0, 0, 4, 7] = 2.0, 1.5, 1.4   # interior peak
    hm[0, 1, 15, 0] = 2.0                                            # corner peak
    hm[0, 2, 0, 9] = 2.0                                             # top-border peak
    hm[1, 0, 7, 7] = hm[1, 0, 3, 3] = 2.0                            # tie: first index
    hm[1, 1, 6, 6], hm[1, 1, 6, 5], hm[1, 1, 6, 7] = 2.0, 1.0, 1.0   # equal neighbours
    got = heatmaps_to_landmarks(torch.from_numpy(hm)).numpy()
    want = np.asarray(j_heatmaps_to_landmarks(jnp.asarray(hm.transpose(0, 2, 3, 1))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [7.25, 4.75])
    np.testing.assert_array_equal(got[0, 1], [0.0, 15.0])
    np.testing.assert_array_equal(got[0, 2], [9.0, 0.0])
    assert np.abs(got[1, 0] - [3.0, 3.0]).max() <= 0.25
    assert got[1, 1, 0] == 6.0


@functools.lru_cache(maxsize=None)
def small_stacks(seed=9):
    """The JAX and the port detector + landmarker at the small sizes, with
    the same numpy-seeded weights, reference-style files converted by the
    JAX package's converters (one pair a process: the JAX programs compile
    once for every test file that uses them)."""
    det_p = convert_retinaface(_np(reference_state_dict(lambda: RetinaFace(CFG_MNET), seed)),
                               J_CFG_MNET)
    fan_p = convert_fan(_np(reference_state_dict(lambda: FAN(**FAN_CFG), seed + 1)),
                        FAN_CFG["num_modules"], FAN_CFG["depth"])
    jconfig = jdetect.DetectorConfig(det_size=DET, max_faces=4)
    config = detect.DetectorConfig(det_size=DET, max_faces=4)
    jstack = jdetect.FaceLandmarkDetector(
        jdetect.RetinaFaceDetector(det_p, J_CFG_MNET, jconfig),
        jdetect.FANLandmarker(fan_p, resolution=FAN_RES, **FAN_CFG))
    stack = detect.FaceLandmarkDetector(
        detect.RetinaFaceDetector(retinaface_state_dict_from_jax(det_p, CFG_MNET), CFG_MNET,
                                  config, device="cpu"),
        detect.FANLandmarker(fan_state_dict_from_jax(fan_p, 1, 2),
                             resolution=FAN_RES, device="cpu", **FAN_CFG))
    return jstack, stack


@pytest.fixture(scope="module")
def stacks():
    return small_stacks()


def _frames(seed, b, h=150, w=200):
    """Smooth uint8 frames (a coarse grid upsampled, plus noise)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((b, h // 10 + 1, w // 10 + 1, 3))
    img = np.kron(coarse, np.ones((1, 10, 10, 1)))[:, :h, :w] * 200
    return (img + rng.random(img.shape) * 55).astype(np.uint8)


def _close(got, want, atol, what):
    assert np.asarray(got).shape == np.asarray(want).shape, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def test_detector_matches_jax_on_a_non_square_frame(stacks):
    """The 150x200 frame is resized to 120x160 and zero padded to 160^2:
    every candidate row (boxes, scores, 5 points), and `detect` with and
    without the fallback, within 1e-3 px and 1e-5 in score."""
    jstack, stack = stacks
    frames = _frames(10, 2)
    got = stack.detector._run(detect.upload(frames[0], "cpu")[None])
    imgs, scale = jstack.detector._preprocess(jnp.asarray(frames[0])[None])
    jb, jsc, jlm = jax.device_get(jstack.detector._run(jstack.detector._packed, imgs[0]))
    _close(got[0][0], jb / scale, 1e-3, "boxes")
    _close(got[1][0], jsc, 1e-5, "scores")
    _close(got[2][0], jlm / scale, 1e-3, "lm5")
    try:
        for fallback in (True, False):
            stack.detector.fallback_best = jstack.detector.fallback_best = fallback
            for frame in frames:
                for g, w in zip(stack.detector.detect(frame), jstack.detector.detect(frame)):
                    _close(g, w, 1e-3, f"detect, fallback {fallback}")
    finally:
        stack.detector.fallback_best = jstack.detector.fallback_best = True


def test_detect_batch_and_landmarks_video_match_jax(stacks):
    jstack, stack = stacks
    frames = _frames(12, 3)
    got, want = stack.detector.detect_batch(frames, chunk=2), \
        jstack.detector.detect_batch(frames, chunk=2)
    for g, w, tol in zip(got, want, (1e-3, 1e-5, 1e-3)):
        _close(g, w, tol, "detect_batch")
    lm, sc = stack.landmarks_video(frames, chunk=2)
    jlm, jsc = jstack.landmarks_video(frames, chunk=2)
    _close(lm, jlm, 1e-3, "landmarks_video")
    _close(sc, jsc, 1e-5, "best scores")


def test_landmarks_and_detect_all_match_jax(stacks):
    jstack, stack = stacks
    frame = _frames(13, 1)[0]
    boxes = np.array([[40.0, 30.0, 120.0, 130.0], [100.0, 20.0, 190.0, 110.0]], np.float32)
    _close(stack.landmarker.landmarks(frame, boxes),
           jstack.landmarker.landmarks(frame, boxes), 1e-3, "landmarks")
    assert stack.landmarker.landmarks(frame, boxes[:0]).shape == (0, 68, 2)
    for g, w in zip(stack.detect_all(frame), jstack.detect_all(frame)):
        _close(g, w, 1e-3, "detect_all")
    _close(stack(frame), jstack(frame), 1e-3, "best face")


def test_default_landmarker_reads_reference_checkpoints(tmp_path):
    """Reference-named torch files in weights_dir: the port reads them
    natively, folds the detector's stem and gates on the score threshold
    (no fallback); every candidate row and the landmarks of given boxes
    equal those of a stack built from what the JAX package's converters make
    of the same files."""
    det = reference_state_dict(lambda: RetinaFace(CFG_MNET), 14)
    fan = reference_state_dict(lambda: FAN(**FAN_CFG), 15)
    torch.save(det, tmp_path / "RetinaFace-mobile0.25.pth")
    torch.save(fan, tmp_path / "2DFAN4.pth")
    stack = detect.default_landmarker(str(tmp_path), det_size=DET, fan_modules=1,
                                      fan_features=32, fan_depth=2, fan_resolution=FAN_RES,
                                      device="cpu")
    assert not stack.detector.fallback_best and stack.min_score == 0.9
    want = detect.FaceLandmarkDetector(
        detect.RetinaFaceDetector(
            retinaface_state_dict_from_jax(convert_retinaface(_np(det), J_CFG_MNET), CFG_MNET),
            CFG_MNET, detect.DetectorConfig(det_size=DET), fallback_best=False, device="cpu"),
        detect.FANLandmarker(fan_state_dict_from_jax(convert_fan(_np(fan), 1, 2), 1, 2),
                             resolution=FAN_RES, device="cpu", **FAN_CFG))
    frame = _frames(16, 1)[0]
    # the two folds sum conv(W, mean) in their own float32 order
    for g, w, tol in zip(stack.detector._run(detect.upload(frame, "cpu")[None]),
                         want.detector._run(detect.upload(frame, "cpu")[None]),
                         (1e-3, 1e-5, 1e-3)):
        _close(g, w, tol, "candidates from checkpoints")
    boxes = np.array([[40.0, 30.0, 120.0, 130.0]], np.float32)
    np.testing.assert_array_equal(stack.landmarker.landmarks(frame, boxes),
                                  want.landmarker.landmarks(frame, boxes))
    for g, w in zip(stack.detect_all(frame), want.detect_all(frame)):
        _close(g, w, 1e-3, "detect_all from checkpoints")


def test_default_landmarker_demo_mode(monkeypatch, tmp_path):
    """No checkpoints: random weights from seeded generators, a warning,
    the fallback on and no score floor, and a face in any frame."""
    monkeypatch.setenv("E4S_WEIGHTS", str(tmp_path))
    small = dict(det_size=DET, fan_modules=1, fan_features=32, fan_depth=2,
                 fan_resolution=FAN_RES, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM"):
        a = detect.default_landmarker(**small)
    with pytest.warns(UserWarning, match="RANDOM"):
        b = detect.default_landmarker(**small)
    assert a.detector.fallback_best and a.min_score is None
    for x, y in ((a.detector.model, b.detector.model), (a.landmarker.model, b.landmarker.model)):
        for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(v, w), k
    lm = a(_frames(17, 1)[0])
    assert lm.shape == (68, 2) and np.isfinite(lm).all()


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the check is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect.default_landmarker(det_size=DET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect.RetinaFaceDetector(reference_state_dict(lambda: RetinaFace(CFG_MNET), 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect.FANLandmarker(reference_state_dict(lambda: FAN(**FAN_CFG), 0), **FAN_CFG)
