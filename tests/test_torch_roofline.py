"""The port's roofline held against the JAX package: the analytic model
(``forward_flops``, ``decode_flops``, ``cell_flops``, ``cell_hbm_bytes``)
for all 40 (architecture × input shape) cells, ``model_flops`` and
``active_param_count`` for every architecture, both to 1e-12 relative
(the same arithmetic; the parameter counts each side's own), the HLO-text
parsers on the reference's own test texts, and the three terms at the
H100's data-sheet rates."""

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.parallel.sharding import count_params as ref_count_params  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline import analytic as ref_analytic  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.models import param_defs  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.roofline import analysis, analytic  # noqa: E402

REL = 1e-12
HLO = """
  %ag = bf16[1024,512]{1,0} all-gather(%x), dimensions={0}
  %ar.1 = f32[256]{0} all-reduce(%y), to_apply=%add
  %rs = (f32[128]{0}, f32[128]{0}) reduce-scatter(%a, %b), dimensions={0}
  %cp = u32[64]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %a2a = bf16[32,32]{1,0} all-to-all(%w), dimensions={1}
  %ags = bf16[8,8]{1,0} all-gather-start(%v), dimensions={0}
  %agd = bf16[8,8]{1,0} all-gather-done(%ags)
"""


def _counts(arch):
    return (count_params(param_defs(get_config(arch))),
            ref_count_params(ref_build_model(ref_get_config(arch)).param_defs()))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_analytic_cell_matches_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    cell, ref_cell = SHAPES[shape], REF_SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    n, ref_n = _counts(arch)
    assert n == ref_n
    pairs = {
        "forward_flops": (analytic.forward_flops(cfg, B, S),
                          ref_analytic.forward_flops(ref_cfg, B, S)),
        "decode_flops": (analytic.decode_flops(cfg, B, S),
                         ref_analytic.decode_flops(ref_cfg, B, S)),
        "cell_flops": (analytic.cell_flops(cfg, cell),
                       ref_analytic.cell_flops(ref_cfg, ref_cell)),
        "cell_hbm_bytes": (analytic.cell_hbm_bytes(cfg, cell, n),
                           ref_analytic.cell_hbm_bytes(ref_cfg, ref_cell,
                                                       ref_n)),
    }
    for name, (got, want) in pairs.items():
        assert want > 0, name
        assert got == pytest.approx(want, rel=REL), name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_and_active_params_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    n, ref_n = _counts(arch)
    active = analysis.active_param_count(cfg, n)
    assert active == ref_analysis.active_param_count(ref_cfg, ref_n)
    assert (active < n) == bool(cfg.num_experts)
    for shape in SHAPES:
        assert analysis.model_flops(cfg, SHAPES[shape], active) == \
            pytest.approx(ref_analysis.model_flops(
                ref_cfg, REF_SHAPES[shape], active), rel=REL)


def test_hlo_text_parsers_match_reference():
    for text in ("bf16[128,256]", "f32[8]{0}", "(f32[4,4], bf16[2,2])",
                 "pred[16]", HLO):
        assert analysis.shape_bytes(text) == ref_analysis.shape_bytes(text)
    assert analysis.shape_bytes("(f32[4,4], bf16[2,2])") == 64 + 8
    got = analysis.collective_bytes(HLO)
    assert got == ref_analysis.collective_bytes(HLO)
    assert got["all-gather"] == 1024 * 512 * 2 + 8 * 8 * 2
    assert got["reduce-scatter"] == 2 * 128 * 4


def test_roofline_terms_at_h100_rates():
    """989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way; an
    unmeasured collective term reads None and stays out of the bound."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    r = analysis.Roofline(2 * 989e12, 3.35e12, {"all-gather": 450e9 * 3}, 8)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 1.0, 3.0)
    assert (r.dominant, r.bound_s) == ("collective", 3.0)
    u = analysis.Roofline(989e12, 2 * 3.35e12, None, 8)
    s = u.summary()
    assert s["collective_s"] is None and s["collective_bytes_per_device"] is None
    assert (s["dominant"], s["bound_s"]) == ("memory", 2.0)
    assert set(s) == set(ref_analysis.Roofline(1.0, 1.0, {}, 1).summary())
    cfg, cell = get_config("llama3-405b"), SHAPES["train_4k"]
    n = count_params(param_defs(cfg))
    a = analysis.analytic_roofline(cfg, cell, n, 256)
    assert a.flops == analytic.cell_flops(cfg, cell) / 256
    assert a.bytes_accessed == analytic.cell_hbm_bytes(cfg, cell, n) / 256
    assert a.dominant == "compute" and a.n_devices == 256
