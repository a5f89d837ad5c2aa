"""The text patches of ``utils/kernel_variants.py`` against the kernel sources
as they stand: every patch of every variant finds its target exactly once,
so that an edit of a kernel that moves a target fails here and not on the
card. Building and timing the variants needs a card and nvcc; making their
source text does not."""

import pytest

from dilabhelmholtzoct_tpu_torch import kernels
from dilabhelmholtzoct_tpu_torch.utils import kernel_variants as kv

CASES = [(target, name) for target, spec in sorted(kv.TARGETS.items())
         for name in spec[3]]


@pytest.mark.parametrize("target,name", CASES)
def test_variant_patches_apply(target, name):
    """``patched`` raises where a target is not found once; a variant's text
    differs from its base (the source with the target's own edit) and
    still holds the kernel it times, and ``base`` is that text unchanged."""
    _, source, kernel, _, _, edit = kv.TARGETS[target]
    base = edit((kernels.CSRC / source).read_text())
    text = kv.patched(target, name)
    assert kernel in text
    assert (text == base) == (name == "base")
