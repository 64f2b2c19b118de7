"""The comparison that decides `correct`, driven on the CPU at a tiny size
with the cells' own limits (`perfbench/workloads/<cell>.json`): the
port's sound runs pass; the control (the reference in TF32, which the
CPU emulates by rounding the products' inputs) fails; and so does a run
with the timed path broken underneath (`perfbench/faults.py`), once for
each fault a cell can have: an answer altered where it is produced, the
swap left undone (the target returned unchanged), and, for a batch, half
of the batch left out, and one image of a full batch of 8 answered at a
wrong index or left undone while the other 7 are sound. The harness's
look for a card is skipped; the rest of a run is the one the card runs.
On the card the control's and the faults' readings are taken at the
cells' own sizes by `perfbench/control.py`."""

import copy

import pytest
import torch

from perfbench import faults, harness
from perfbench.control import control_driver

ROOT = harness.HERE.parent
TINY = {"out_size": 64, "remaining_layer_idx": 7, "encoder_num_units": [1, 1, 1, 1]}
TINY_ZOO = {"gpen_size": 32, "gpen_channel_multiplier": 1, "gpen_narrow": 0.25,
            "blender_size": 16, "rrdb_num_feat": 16, "rrdb_num_block": 1, "rrdb_num_grow": 8,
            "gcfsr_size": 32}
CELLS = ["rgi.swap_b1", "zoo.batch_b8"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tiny_blender(monkeypatch):
    from e4s2024_torch.models.blender import BlenderRecolorer

    monkeypatch.setattr(BlenderRecolorer, "size", TINY_ZOO["blender_size"])


def run_tiny(cell: str, control: bool = False, full_batch: bool = False) -> list:
    """The checks of a run of `cell` at a tiny size: batches of 2 from a
    pool of 4, or with `full_batch` one batch of the cell's own size, not
    warmed."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, workload = harness.cell_files(ROOT, bench, cell)
    config = copy.deepcopy(config)
    config["swap"].update(TINY)
    if "zoo" in config:
        config["zoo"].update(TINY_ZOO)
    batch = traffic["batch"] if full_batch else min(traffic["batch"], 2)
    traffic = dict(traffic, pool=batch if full_batch else 2 * batch, batch=batch, block=8)
    ctx = harness.Context(config=config, traffic=traffic,
                          workload=dict(workload, warm_calls=0 if full_batch else 1),
                          seed=2 ** 31 + 77,
                          device=torch.device("cpu"))
    driver = harness.load_module(harness.HERE / "drivers" / f"{workload['driver']}.py",
                                 f"drv_{workload['driver']}").Driver
    return harness.run_cell(ctx, control_driver(driver) if control else driver, 0.01,
                            False)[3]


@pytest.mark.parametrize("cell", CELLS)
def test_the_ports_run_is_correct(cell, tiny_blender):
    checks = run_tiny(cell)
    assert harness.is_correct(checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, tiny_blender):
    checks = run_tiny(cell, control=True)
    assert not harness.is_correct(checks), checks


@pytest.mark.parametrize("fault", ["answer_altered", "swap_undone"])
def test_a_broken_aligned_swap_is_not_correct(fault):
    with faults.FAULTS["swap_aligned"][fault]():
        assert not harness.is_correct(run_tiny("rgi.swap_b1"))


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_a_broken_batch_swap_is_not_correct(fault, tiny_blender):
    with faults.FAULTS["swap_batch"][fault]():
        assert not harness.is_correct(run_tiny("zoo.batch_b8"))


@pytest.mark.parametrize("fault", ["one_index_wrong", "one_swap_undone"])
def test_one_broken_image_of_a_full_batch_is_not_correct(fault, tiny_blender):
    with faults.FAULTS["swap_batch"][fault]():
        checks = run_tiny("zoo.batch_b8", full_batch=True)
    by_name = {c["name"]: c for c in checks}
    assert by_name["image_mad_median"]["value"] <= by_name["image_mad_median"]["limit"]
    assert not harness.is_correct(checks), checks
