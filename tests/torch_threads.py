"""A module-scoped fixture for the port's heavier CPU tests: torch at 2
intra-op threads and OpenCV at 1 while the module runs, then back.

The tier-1 command runs 6 pytest workers on an 8-core host. At their
defaults torch and OpenCV each start a thread per core in every worker, and
the oversubscribed cores slow every test running beside them (a Trainer
test that takes 3 s alone took 227 s in a full run)."""

import cv2
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n_torch, n_cv = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(2)
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(n_torch)
    cv2.setNumThreads(n_cv)
