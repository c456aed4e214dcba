"""The kernel-variant timing scripts: every named edit still applies to
the kernel source it edits (they run only on the card, so a source that
moved on would otherwise show there first)."""

import pytest

from repro_torch.kernels import build
from repro_torch.launch import fused_variants, ssd_bwd_variants, ssd_variants
from repro_torch.launch.variants import edit


@pytest.mark.parametrize("name", fused_variants.VARIANTS)
def test_fused_variant_edits_apply(name):
    src = (build.CSRC / "gemm.cu").read_text()
    out = fused_variants.variant_source(name, src)
    assert (out == src) == (name == "base")


@pytest.mark.parametrize("name", ssd_variants.VARIANTS)
def test_ssd_variant_edits_apply(name):
    src = (build.CSRC / "mamba2_ssd.cu").read_text()
    out = ssd_variants.variant_source(name, src)
    assert (out == src) == (name in ("base", "hb1", "hb24"))


@pytest.mark.parametrize("name", ssd_bwd_variants.VARIANTS)
def test_ssd_bwd_variant_edits_apply(name):
    src = (build.CSRC / "mamba2_ssd.cu").read_text()
    out = ssd_bwd_variants.variant_source(name, src)
    assert (out == src) == (name in ("base", "hb1", "hb24"))


def test_edit_raises_when_the_text_moved_on():
    assert edit("abc", "b", "x") == "axc"
    with pytest.raises(RuntimeError, match="does not apply"):
        edit("abc", "z", "x")
