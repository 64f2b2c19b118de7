"""The `swinir.enhanced_b1` cell on the CPU at a tiny size: the driver's
comparison with the reference passes on the port's sound run and fails on
the control (the reference in TF32, which the CPU emulates by rounding the
products' inputs) and under each fault planted in the port
(`perfbench/faults_swinir.py`: four in SwinIR, two in the swap), with
the cell's own limits; the plain references load nothing of JAX or of the
port; the K5 roofline reader takes the reference's operation count and the
port's launches.

At the tiny size the port runs each kernel's plain version, in float32 as
the reference does, so its run reads at rounding's level; the limits are
the cell's, set on the card at the published widths (PERF.md §4)."""

import copy
import importlib.util
import subprocess
import sys

import pytest
import torch

from perfbench import faults_swinir, harness
from perfbench.control import control_driver
from perfbench.reference import plain_kernels
from perfbench.reference.swinir import SwinIR, block_operations, seeded_draws

ROOT = harness.HERE.parent
CELL = "swinir.enhanced_b1"
TINY_SWAP = {"out_size": 64, "remaining_layer_idx": 7, "encoder_num_units": [1, 1, 1, 1]}
TINY_SWINIR = {"embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2], "num_feat": 16}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_tiny(control: bool = False) -> list:
    """The checks of a run of the cell at a tiny size: a pool of 2 pairs,
    one warm call."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, workload = harness.cell_files(ROOT, bench, CELL)
    config = copy.deepcopy(config)
    config["swap"].update(TINY_SWAP)
    config["swinir"].update(TINY_SWINIR)
    config["init_overrides"]["swinir"] = seeded_draws(TINY_SWINIR["embed_dim"],
                                                      TINY_SWINIR["num_feat"])
    ctx = harness.Context(config=config, traffic=dict(traffic, pool=2, block=8),
                          workload=dict(workload, warm_calls=1), seed=2 ** 31 + 77,
                          device=torch.device("cpu"))
    driver = harness.load_module(harness.HERE / "drivers" / f"{workload['driver']}.py",
                                 f"drv_{workload['driver']}").Driver
    return harness.run_cell(ctx, control_driver(driver) if control else driver, 0.01,
                            False)[3]


def test_the_ports_run_is_correct():
    checks = run_tiny()
    assert harness.is_correct(checks), checks


def test_the_control_is_not_correct():
    checks = run_tiny(control=True)
    assert not harness.is_correct(checks), checks


@pytest.mark.parametrize("fault", sorted(faults_swinir.FAULTS["swap_enhanced"]))
def test_a_broken_enhanced_swap_is_not_correct(fault):
    with faults_swinir.FAULTS["swap_enhanced"][fault]():
        checks = run_tiny()
    assert not harness.is_correct(checks), checks


def test_the_references_load_nothing_of_jax_or_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.enhanced, perfbench.reference.swinir\n"
            "from perfbench.harness import BANNED_MODULES\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & set(BANNED_MODULES + ('e4s2024_torch',)))\n"
            "print(','.join(bad))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == ""


def test_the_configurations_draws_are_seeded_draws_at_its_widths():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, _, _ = harness.cell_files(ROOT, bench, CELL)
    s = config["swinir"]
    want = seeded_draws(s["embed_dim"], s["num_feat"], s["mlp_ratio"])
    got = config["init_overrides"]["swinir"]
    assert got.keys() == want.keys()
    for key, (kind, std) in want.items():
        assert got[key][0] == kind and got[key][1] == pytest.approx(std, rel=1e-12), key


def test_each_block_is_tallied_as_one_k5_launch():
    net = SwinIR(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4, num_feat=8)
    with torch.no_grad(), plain_kernels.tally() as t:
        net(torch.rand(1, 3, 8, 12))
    assert t.calls["fused_swin_block"] == 4
    assert vars(t)["operations"]["fused_swin_block"] == 4 * block_operations(96, 12, 24, 4)
    # SwinIR-M's block at 1024^2: 3.59 ms at the 3xTF32 rate of an H100
    assert block_operations(1024 ** 2, 180, 360, 8) / (989.4e12 / 6) == pytest.approx(
        3.5897e-3, rel=1e-4)


def _roofline_reader():
    path = harness.HERE / "metrics" / "swin_block_roofline.py"
    spec = importlib.util.spec_from_file_location("reader_swin_block_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_k5_roofline_reader():
    from perfbench.trace import TraceSummary

    tally = plain_kernels.Tally(calls={"fused_swin_block": 36})
    tally.operations = {"fused_swin_block": 36 * 6e11}
    kernel_s = {"void swin_block_kernel<float>(float const*)": 2 * 36 * 0.010,
                "other_kernel": 1.0}
    r = harness.Reading(kind="NVIDIA H100 80GB HBM3", slice_calls=2, ref_tally=tally,
                        trace=TraceSummary(kernel_s=kernel_s),
                        port_launches={"fused_swin_block": 72})
    read = _roofline_reader()
    assert read(r) == pytest.approx(100 * 6e11 / (989.4e12 / 6) / 0.010)
    r.port_launches = {"fused_swin_block": 71}
    assert read(r) is None and "not reported" in r.notes[-1]
