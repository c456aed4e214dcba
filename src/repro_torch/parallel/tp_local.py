"""One layer's blocks split over "model", each rank's share run alone,
against the whole blocks.

The sharded step (``train.train_step``) runs every family's attention
blocks on a rank's heads, its SwiGLUs on a rank's FFN columns, the
Mamba-2 mixer on a rank's ``d_inner`` channels and heads and the MoE
layer's routed experts on a rank's experts, with Megatron's conjugate
all-reduces around them.  Here every rank ``r < P`` of such a split runs
in one process, on its local weights (each cut along the dimensions the
compute keeps split, those its logical "tp" or "ep" axis resolves to
"model" on a mesh of P, as the sharded step holds them) and with a
:class:`~repro_torch.parallel.sharding.TensorParallel` of no group, so
each conjugate is the identity and a block returns the rank's partial
output and, backward, its partial input gradient.  What the step's
all-reduces compute is then their sum over the ranks, held against the
whole block on the same input and upstream gradient:

  * the output (the row-parallel product's partial sums);
  * the input gradient (the column-parallel products' partial sums),
    and the cross-attention's memory's;
  * each weight's gradient: a split weight's blocks side by side, a
    replicated one's (the norms, ``wk``/``wv`` where the kv heads do not
    divide P, the mixer's ``w_bc``/``conv_bc``, the MoE router) summed
    over the ranks.

The MoE layer's routing is computed whole on every rank, outside the
split region, and only its rows and gates enter it: the router's
gradient from the ranks' partial gates sums to the whole's (the block's
output is the routed and shared experts' partial sums together, before
the residual; the aux loss, whole on each rank, is not in its
objective).

The mixer's gated norm reads the whole ``d_inner``'s mean of squares
inside the region (``sharding.tp_sum``), so its ranks cannot run with an
identity there: each rank's statistic is replayed from the ranks' sums.
The ranks run in passes; in each, every all-reduce of ``tp_sum`` records
its input and returns the sum over the ranks that the previous pass
recorded at the same call.  The first pass gets the forward's sum right,
the second the backward's, and the passes stop when one records what
the previous one did: its outputs are the true ranks'.  A block with no
statistic runs one pass.

``chip_smoke.py`` runs it on the card at qwen3-4b's, qwen2-vl-72b's
(its M-RoPE positions given), seamless-m4t-medium's, zamba2-7b's and
deepseek-moe-16b's published widths (K4, K5 and their backward on each
rank's heads; the routed experts' products on each rank's experts);
``tests/test_torch_tp.py`` on the CPU.
"""

from __future__ import annotations

import torch

from ..launch.mesh import MeshShape
from ..models import layers as L
from ..models import param_defs
from ..train.train_step import tp_dims
from .sharding import TensorParallel, resolve_spec


def local_params(defs: dict, params: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s views of one layer's ``params`` on a "model" axis
    of ``size``: each tensor narrowed along the dimensions the compute
    keeps split (``train_step.tp_dims`` of its declaration in ``defs``)
    where ``resolve_spec`` splits them over "model" (an axis that does
    not divide its dimension is dropped)."""
    mesh = MeshShape((size,), ("model",))
    out = {}
    for name, t in params.items():
        logical = defs[name].logical
        spec = resolve_spec(logical, mesh, tuple(t.shape))
        for d in tp_dims(name, logical):
            if spec[d] == "model":
                n = t.shape[d] // size
                t = t.narrow(d, rank * n, n)
        out[name] = t
    return out


def _positions(h):
    B, S = h.shape[:2]
    return torch.arange(S, device=h.device).expand(B, S)


def _attention(model, p, x, tp, positions=None):
    mrope = {} if positions is None else {"mrope_positions": positions}
    return model._attend(p, x["h"], _positions(x["h"]), tp=tp, **mrope)[0]


def _mlp(model, p, x, tp):
    cfg = model.cfg
    return L.ffn(L.rms_norm(x["h"], p["ln_mlp"], cfg.norm_eps), p["w_gate"],
                 p["w_up"], p["w_down"], cfg.d_ff, tp)


def _self_attention(causal):
    def fn(model, p, x, tp):
        h = x["h"]
        normed = L.rms_norm(h, p["ln_attn"], model.cfg.norm_eps)
        return model._attend(p, normed, positions=_positions(h),
                             causal=causal, tp=tp)[0]
    return fn


def _cross_attention(model, p, x, tp):
    kv = model._mem_kv(p, x["mem"], tp)
    return model._attend(p, L.rms_norm(x["h"], p["ln_x"], model.cfg.norm_eps),
                         names=("xq", "xk", "xv", "xo"), kv=kv, causal=False,
                         tp=tp)[0]


def _moe(model, p, x, tp):
    return model._mlp_out(p, x["h"], True, tp=tp)[0]


def _mamba(model, p, x, tp):
    cfg = model.cfg
    return L.mamba2_mix(L.rms_norm(x["h"], p["ln"], cfg.norm_eps), p,
                        d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                        expand=cfg.ssm_expand, tp=tp)[0]


_ATTN = ("ln_attn", "wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP = ("ln_mlp", "w_gate", "w_up", "w_down")
# block: (its function on (model, params, inputs, tp), the parameters it
# reads, where they are in the model's declarations: a layer of
# "layers" or "enc_layers", or the hybrid's "shared" block)
BLOCKS = {
    # DecoderLM (dense, MoE, VLM): causal, the model's window; the VLM's
    # M-RoPE positions (3, B, S) where check_block is given them
    "attention": (_attention, _ATTN, "layers"),
    # the SwiGLU of every family
    "mlp": (_mlp, _MLP, "layers"),
    # DecoderLM's MoE layer: its pre-norm, the routing (whole on every
    # rank), the rank's routed experts and its shared experts' columns
    "moe": (_moe, ("ln_mlp", "router", "e_gate", "e_up", "e_down",
                   "s_gate", "s_up", "s_down"), "layers"),
    # EncDecLM: the encoder's non-causal self-attention and SwiGLU, the
    # decoder's causal self-attention and its cross-attention (the
    # memory's keys and values on the rank's kv heads, sq != sk)
    "enc_attention": (_self_attention(False), _ATTN, "enc_layers"),
    "enc_mlp": (_mlp, _MLP, "enc_layers"),
    "self_attention": (_self_attention(True), _ATTN, "layers"),
    "cross_attention": (_cross_attention, ("ln_x", "xq", "xk", "xv", "xo"),
                        "layers"),
    # ZambaLM and MambaLM: the Mamba-2 mixer on the rank's heads (after
    # the layer's pre-norm), and the hybrid's shared block, its windowed
    # attention and its SwiGLU
    "mamba": (_mamba, ("ln", "w_z", "w_x", "w_bc", "w_dt", "conv_x",
                       "conv_bc", "dt_bias", "a_log", "norm", "w_out"),
              "layers"),
    "shared_attention": (_attention, _ATTN, "shared"),
    "shared_mlp": (_mlp, _MLP, "shared"),
}


def holds(block: str, params: dict) -> bool:
    """Whether a layer's ``params`` hold ``block``: its first weight
    after the pre-norm among them (an MoE layer holds "moe", not
    "mlp")."""
    return BLOCKS[block][1][1] in params


class _Replayed(TensorParallel):
    """Rank ``rank`` of ``size`` run alone: each all-reduce that reaches
    it (``sharding.tp_sum``'s; the conjugates are the identity without a
    group) appends its input to ``seen[call]`` and takes ``sums[call]``,
    the ranks' sum an earlier pass recorded, where there is one."""

    def __init__(self, rank: int, size: int, sums: dict, seen: dict):
        super().__init__(rank, size)
        self.sums, self.seen, self.calls = sums, seen, 0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> None:
        if op != "sum":
            raise ValueError(f"replayed all-reduce of {op!r}")
        call, self.calls = self.calls, self.calls + 1
        self.seen.setdefault(call, []).append(x.detach().clone())
        if call in self.sums:
            x.copy_(self.sums[call])


def _run(fn, model, p: dict, inputs: dict, dy: torch.Tensor, tp,
         static: dict):
    """``fn``'s output, its inputs' gradients and its weights' gradients
    under the upstream gradient ``dy`` (``static``: its keyword inputs
    that take no gradient)."""
    p = {k: v.detach().requires_grad_() for k, v in p.items()}
    x = {k: v.detach().requires_grad_() for k, v in inputs.items()}
    out = fn(model, p, x, tp, **static)
    out.backward(dy)
    return (out.detach(), {k: v.grad for k, v in x.items()},
            {k: v.grad for k, v in p.items()})


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in fp64."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _ranks(fn, model, defs, p, inputs, dy, size, static):
    """Every rank's run (their local weights), in passes until one
    records the statistics the previous pass did (module docstring):
    the last pass's runs and the number of passes."""
    sums: dict = {}
    for passes in range(1, 8):
        seen: dict = {}
        runs = [_run(fn, model, local_params(defs, p, r, size), inputs, dy,
                     _Replayed(r, size, sums, seen), static)
                for r in range(size)]
        new = {k: torch.stack(v).sum(0) for k, v in seen.items()}
        if new.keys() == sums.keys() and all(
                torch.equal(new[k], sums[k]) for k in new):
            return runs, passes
        sums = new
    raise RuntimeError("the replayed statistics did not settle in 7 passes")


def check_block(model, layer: int, block: str, h: torch.Tensor,
                dy: torch.Tensor, size: int, params: dict | None = None,
                memory: torch.Tensor | None = None,
                positions: torch.Tensor | None = None) -> dict:
    """The whole ``block`` (a name of :data:`BLOCKS`) of ``model``'s
    layer ``layer`` of its stack (ignored for the shared block) on ``h``
    (B, S, D), and on the cross-attention's ``memory`` (B, Sk, D),
    against its ``size`` ranks' shares run one by one: the relative
    errors (over max|whole|) of the summed outputs (``out``), input
    gradients (``dx``, and the memory's ``dmem``) and weight gradients
    (``grads``, by name), and the ``passes`` the ranks ran.  ``params``
    (default: the layer's own tensors) gives the weights, in their type
    (an fp32 copy of a bf16 model's, say).  ``positions`` (3, B, S) are
    the M-RoPE positions of an ``"attention"`` block of a model that
    takes them (the VLM backbone's), the whole block's and every
    rank's."""
    fn, names, stack = BLOCKS[block]
    defs = param_defs(model.cfg)[stack]
    if stack == "shared":
        src = model.top.tensors()["shared"]
    else:
        defs = defs[layer]
        src = getattr(model, stack)[layer].tensors()
    if params is not None:
        src = params
    p = {k: v for k, v in src.items() if k in names}
    inputs = {"h": h} if memory is None else {"h": h, "mem": memory}
    static = {}
    if positions is not None:
        if block != "attention" or not model.cfg.mrope:
            raise ValueError(f"M-RoPE positions for block {block!r} of "
                             f"{model.cfg.name}")
        static["positions"] = positions
    out, dx, grads = _run(fn, model, p, inputs, dy, None, static)
    acc_out = torch.zeros_like(out, dtype=torch.float64)
    acc_dx = {k: torch.zeros_like(d, dtype=torch.float64)
              for k, d in dx.items()}
    acc = {k: torch.zeros_like(g, dtype=torch.float64)
           for k, g in grads.items()}
    runs, passes = _ranks(fn, model, defs, p, inputs, dy, size, static)
    for r, (o, d, g) in enumerate(runs):
        acc_out += o.double()
        for k, dk in d.items():
            acc_dx[k] += dk.double()
        for k, gk in g.items():
            # a split weight's gradient is its block's; a replicated
            # one's this rank's partial sum
            view = local_params(defs, {k: acc[k]}, r, size)[k]
            view += gk.double()
    got = dict(out=_err(acc_out, out), dx=_err(acc_dx["h"], dx["h"]),
               grads={k: _err(acc[k], grads[k]) for k in grads},
               passes=passes)
    if memory is not None:
        got["dmem"] = _err(acc_dx["mem"], dx["mem"])
    return got
