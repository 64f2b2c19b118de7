"""The training CLI's parts against the JAX package's, on the CPU: the
datasets on a tiny PNG tree (items, NCHW batches, shards), the label
converters, `E4SConfig`, the checkpoint IO, `train.main` for 2 steps, and
one G step and one D step with R1 under DistributedDataParallel at world
size 1 (gloo over a FileStore) against the same steps without it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from e4s2024_tpu import config as jconfig
from e4s2024_tpu.data import datasets as jdatasets
from e4s2024_tpu.data import labels as jlabels

from e4s2024_torch import config, train
from e4s2024_torch.data import datasets, labels
from e4s2024_torch.parallel.ddp import make_process_group
from e4s2024_torch.training.coach import Coach, TrainConfig
from e4s2024_torch.utils.checkpoint import load_pytree, load_zoo, save_pytree, save_zoo
from tests.test_torch_coach import TINY, _batches, _nchw
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)


def _png_tree(root, size):
    """root/{train,test}/{images,labels}: 6 RGB size^2 images and 19-class
    label maps each."""
    rng = np.random.default_rng(0)
    for mode in ("train", "test"):
        (root / mode / "images").mkdir(parents=True)
        (root / mode / "labels").mkdir(parents=True)
        for i in range(6):
            img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
            lbl = rng.integers(0, 19, (size, size), dtype=np.uint8)
            Image.fromarray(img).save(root / mode / "images" / f"{i:05d}.png")
            Image.fromarray(lbl, mode="L").save(root / mode / "labels" / f"{i:05d}.png")
    return root


@pytest.fixture
def tree(tmp_path):
    return _png_tree(tmp_path, 32)


@pytest.mark.parametrize("kw", [dict(mode="all"), dict(mode="train", fraction=0.5),
                                dict(mode="test", flip_p=0.5, label_format="ffhq19"),
                                dict(mode="train", paired=True)])
def test_dataset_items_match_jax(tree, kw):
    ds, jds = datasets.FaceMaskDataset(str(tree), **kw), jdatasets.FaceMaskDataset(str(tree), **kw)
    assert len(ds) == len(jds) and ds.imgs == jds.imgs and ds.labels == jds.labels
    def leaves(item):  # (img, label), or a pair of them when paired
        return [a for part in item for a in leaves(part)] if isinstance(item, tuple) else [item]

    for i in range(len(ds)):
        got, want = leaves(ds[i]), leaves(jds[i])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_batches_match_jax_in_nchw(tree, shard):
    """The same shuffled, flipped, label-resized batches as JAX's, NCHW."""
    kw = dict(mode="all", flip_p=0.5, seed=3)
    it = datasets.FaceMaskDataset(str(tree), **kw).batches(2, onehot_size=16, shard=shard)
    jit = jdatasets.FaceMaskDataset(str(tree), **kw).batches(2, onehot_size=16, shard=shard)
    for _ in range(4):
        (img, onehot), (jimg, jonehot) = next(it), next(jit)
        assert img.shape == (2, 3, 32, 32) and onehot.shape == (2, 12, 16, 16)
        np.testing.assert_array_equal(img, jimg.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(onehot, jonehot.transpose(0, 3, 1, 2))


def test_label_converters_match_jax():
    """19 -> 12 classes from numpy and from a tensor, and the one-hot with
    the classes before the spatial axes."""
    lbl = np.random.default_rng(1).integers(0, 19, (2, 5, 7))
    for ours, theirs in ((labels.celebahq19_to_face12, jlabels.celebahq19_to_face12),
                         (labels.ffhq19_to_face12, jlabels.ffhq19_to_face12)):
        want = theirs(lbl)
        np.testing.assert_array_equal(ours(lbl), want)
        np.testing.assert_array_equal(ours(torch.from_numpy(lbl)).numpy(), want)
    face = jlabels.ffhq19_to_face12(lbl)
    want = np.asarray(jlabels.label_map_to_one_hot(face)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(labels.label_map_to_one_hot(face), want)
    np.testing.assert_array_equal(labels.label_map_to_one_hot(torch.from_numpy(face)).numpy(),
                                  want)


def test_config_from_args_and_json():
    """The same defaults as the JAX package's tree, flags onto the train
    section (bools by word), and a JSON dump."""
    for name in ("train", "optim", "data", "checkpoints"):
        assert (dataclasses.asdict(getattr(config.E4SConfig(), name))
                == dataclasses.asdict(getattr(jconfig.E4SConfig(), name))), name
    cfg = config.E4SConfig.from_args(["--exp_dir", "x", "--batch_size", "4", "--remat", "true",
                                      "--optim_name", "ranger", "--learning_rate", "3e-4"])
    assert cfg.exp_dir == "x" and cfg.train.batch_size == 4 and cfg.train.remat is True
    assert cfg.train.optim_name == "ranger" and cfg.train.learning_rate == 3e-4
    assert json.loads(cfg.to_json())["train"]["batch_size"] == 4
    with pytest.raises(SystemExit):
        config.E4SConfig.from_args(["--remat", "maybe"])


def test_checkpoint_io_round_trips(tmp_path):
    tree_ = {"step": 3, "w": {"a": torch.arange(4.0)}, "opt": [{"count": 2}]}
    save_pytree(str(tmp_path / "one" / "t.pt"), tree_)
    back = load_pytree(str(tmp_path / "one" / "t.pt"))
    assert back["step"] == 3 and back["opt"] == [{"count": 2}]
    assert torch.equal(back["w"]["a"], tree_["w"]["a"])
    save_zoo(str(tmp_path / "zoo"), {"rgi": {"x": torch.ones(2)}, "bisenet": {"y": torch.zeros(1)}})
    zoo = load_zoo(str(tmp_path / "zoo"))
    assert sorted(zoo) == ["bisenet", "rgi"] and torch.equal(zoo["rgi"]["x"], torch.ones(2))


def test_train_main_runs_two_steps(tmp_path, capsys):
    """`python -m e4s2024_torch.train --device cpu` at a tiny size for 2
    steps, on a tree of 16^2 images (the CLI, as the JAX package's, trains
    at the images' size): opt.json, the step-0 log line, validation at step
    2 and its best-val save."""
    data, exp = _png_tree(tmp_path / "data", 16), tmp_path / "exp"
    train.main(["--device", "cpu", "--data_root", str(data), "--exp_dir", str(exp),
                "--out_size", "16", "--remaining_layer_idx", "5", "--channel_multiplier", "1",
                "--encoder_input_size", "32", "--batch_size", "2", "--regional_mode", "fast",
                "--max_steps", "2", "--val_every", "2", "--val_steps", "1"])
    opt = json.loads((exp / "opt.json").read_text())
    assert opt["train"]["max_steps"] == 2 and opt["exp_dir"] == str(exp)
    out = capsys.readouterr().out
    assert "[step 0]" in out and "d_loss=" in out and "loss_l2=" in out
    best = load_pytree(str(exp / "best.pt"))
    assert best["step"] == 2 and "G.conv1.conv.weight" in best["params"]


@pytest.mark.parametrize("kind", ["g", "d_r1"])
def test_ddp_step_at_world_size_one_matches(tmp_path, kind):
    """One G step, or one D step with R1 (three forwards of the wrapped D,
    R1's create-graph gradient through it, one backward), of a Coach in
    DistributedDataParallel (gloo, world size 1, a FileStore) equals the
    same step without it: metrics and updated parameters within 1e-5
    relative."""
    (img, onehot), = _nchw(_batches(11, 1))
    cfg = TrainConfig(**TINY)
    results = []
    for with_group in (False, True):
        group = None
        try:
            if with_group:
                group = make_process_group(1, 0, device="cpu",
                                           store=dist.FileStore(str(tmp_path / "store"), 1))
            coach = Coach(cfg, process_group=group, device="cpu")
            state = coach.init_state(torch.Generator().manual_seed(2))
            inputs = coach._as_device(img, onehot)
            if kind == "g":
                state, metrics = coach.g_step(state, *inputs)
                params = state.params
            else:
                state, metrics = coach.d_step(state, *inputs, with_r1=True)
                assert "r1_loss" in metrics
                params = state.d_params
            results.append(({k: float(v) for k, v in metrics.items()},
                            {k: p.detach().clone() for k, p in params.items()}))
        finally:
            if group is not None:
                dist.destroy_process_group()
    (m0, p0), (m1, p1) = results
    assert m1 == pytest.approx(m0, rel=1e-5)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=1e-5, atol=1e-7, msg=k)
    with pytest.raises(RuntimeError, match="CUDA|visible"):
        make_process_group(2, 0, device="cuda", init_method="tcp://localhost:1")


def test_loss_params_from_reference_files(tmp_path):
    """`load_all_loss_params` reads the LPIPS reference files (torchvision's
    AlexNet with its classifier, the v0.1 lin heads renamed `{i}.1.weight`)
    into the port's LPIPS state dict; unset paths give no entry."""
    from e4s2024_torch.models.lpips import LPIPS

    torch.manual_seed(3)
    sd = LPIPS().state_dict()
    alex = {k: v for k, v in sd.items() if k.startswith("features.")}
    alex["classifier.1.weight"] = torch.zeros(2, 2)
    lin = {f"{k[3]}.1.weight": v for k, v in sd.items() if k.startswith("lin")}
    torch.save(alex, tmp_path / "alex.pth")
    torch.save(lin, tmp_path / "lin.pth")
    ckpts = config.CheckpointConfig(lpips_alex=str(tmp_path / "alex.pth"),
                                    lpips_lin=str(tmp_path / "lin.pth"))
    out = config.load_all_loss_params(ckpts)
    assert set(out) == {"lpips"} and set(out["lpips"]) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out["lpips"][k], v), k
    LPIPS().load_state_dict(out["lpips"], strict=True)
