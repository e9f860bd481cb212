"""The input pool: made from the seed, of the mix's shapes, content that is
not flat, exposures stratified."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.traffic import content

from .conftest import small_cell
from .test_portbench_reference import CELLS

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_pool_is_made_from_the_seed(name):
    mix = small_cell(name).traffic
    a, b = content.make_pool(mix, 2**31 + 3, CPU), content.make_pool(mix, 2**31 + 3, CPU)
    c = content.make_pool(mix, 2**31 + 4, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert len(a) == content.pool_batches(mix)
    assert all(tuple(x.shape) == content.batch_shape(mix) for x in a)
    assert all(x.dtype == {"uint8": torch.uint8, "uint16": torch.uint16}[mix["dtype"]] for x in a)
    assert len({x.to(torch.int32).sum().item() for x in a}) == len(a)  # distinct batches


@pytest.mark.parametrize("name", CELLS)
def test_content_is_dark_and_not_flat(name):
    mix = small_cell(name).traffic
    x = content.make_pool(mix, 1, CPU)[0].to(torch.int32)
    top = (1 << mix["bits"]) - 1
    assert int(x.max()) <= top
    hist = torch.bincount(x.view(-1), minlength=top + 1).to(torch.float32)
    assert (hist > 0).sum() > 20  # many levels, not a few flat regions
    assert x.float().mean() < 0.5 * top  # a dark exposure


def test_pool_sizes_of_the_mixes():
    sizes = {name: content.pool_batches(harness.load_cell(name).traffic) for name in CELLS}
    assert list(sizes.values()) == [4, 4, 6, 16]


def test_exposures_are_stratified():
    g = torch.Generator().manual_seed(4)
    s = content._strata(8, 0.2, 0.6, g, CPU)
    assert torch.allclose(s.sort().values, 0.2 + 0.4 * (torch.arange(8) + 0.5) / 8)
