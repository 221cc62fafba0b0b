"""The harness's tiny cells on the card: correct, their control not, and a
traced run whose device metrics read (the profiler's kernels and the
refine kernel's launches).  Run on the GPU machine with
``python -m pytest -p no:cacheprovider -m cuda perfbench/tests/test_pb_cuda.py``."""

import time

import pytest
import torch

import pb_tiny
from perfbench.core.harness import run_cell

CELLS = ("tless.served", "linemod.match", "tless.match")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("pbcuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(card, root, cell):
    res = run_cell(root, cell, pb_tiny.SEED, 1.0, False, card, time.perf_counter())
    assert res["correct"] is True, res["check"]
    ctl = run_cell(root, cell, pb_tiny.SEED, 1.0, False, card, time.perf_counter(), control=True)
    assert ctl["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_cell_on_the_card(card, root, cell):
    res = run_cell(root, cell, pb_tiny.SEED, 1.0, True, card, time.perf_counter())
    assert res["correct"] is True
    m = res["metrics"]
    assert 0.0 <= m["device.idle_share"]["value"] < 100.0
    assert m["device.launches_per_frame"]["value"] > 0
    assert 0.0 < m["local_refine.roofline"]["value"] <= 105.0
    assert 0.0 < res["device"]["busy_s"] <= res["device"]["window_s"]
