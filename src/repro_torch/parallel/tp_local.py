"""One decoder layer's blocks split over "model", each rank's share run
alone, against the whole blocks.

The sharded step (``train.train_step``) runs ``DecoderLM``'s attention
and SwiGLU blocks on a rank's heads and FFN columns, with Megatron's
conjugate all-reduces around them.  Here every rank ``r < P`` of such a
split runs in one process, on its local weights (each cut along the
dimensions its logical "tp" axis resolves to "model" on a mesh of P,
as the sharded step holds them) and with a :class:`~repro_torch.parallel.
sharding.TensorParallel` of no group, so each conjugate is the identity
and a block returns the rank's partial output and, backward, its partial
input gradient.  What the step's all-reduces compute is then their sum
over the ranks, held against the whole block on the same input and
upstream gradient:

  * the output (the row-parallel product's partial sums);
  * the input gradient (the column-parallel products' partial sums);
  * each weight's gradient: a split weight's blocks side by side, a
    replicated one's (the norms, ``wk``/``wv`` where the kv heads do not
    divide P) summed over the ranks.

``chip_smoke.py`` runs it on the card at qwen3-4b's published widths
(K4 and its backward on each rank's heads); ``tests/test_torch_tp.py``
on the CPU.
"""

from __future__ import annotations

import torch

from ..launch.mesh import MeshShape
from ..models import layers as L
from ..models import param_defs
from .sharding import TensorParallel, resolve_spec


def local_params(defs: dict, params: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s views of one layer's ``params`` on a "model" axis
    of ``size``: each tensor narrowed along the dimensions its declared
    logical axes (``defs``, the layer's :class:`~repro_torch.models.
    params.ParamDef`) split over "model" (``resolve_spec``'s rule: an
    axis that does not divide its dimension is dropped)."""
    mesh = MeshShape((size,), ("model",))
    out = {}
    for name, t in params.items():
        spec = resolve_spec(defs[name].logical, mesh, tuple(t.shape))
        for d, entry in enumerate(spec):
            if entry == "model":
                n = t.shape[d] // size
                t = t.narrow(d, rank * n, n)
        out[name] = t
    return out


def _attention(model, p, h, tp):
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    return model._attend(p, h, positions, tp=tp)[0]


def _mlp(model, p, h, tp):
    x = L.rms_norm(h, p["ln_mlp"], model.cfg.norm_eps)
    return model._ffn(x, p["w_gate"], p["w_up"], p["w_down"],
                      model.cfg.d_ff, tp)


BLOCKS = {"attention": (_attention, ("ln_attn", "wq", "wk", "wv", "wo",
                                     "q_norm", "k_norm")),
          "mlp": (_mlp, ("ln_mlp", "w_gate", "w_up", "w_down"))}


def _run(fn, model, p: dict, h: torch.Tensor, dy: torch.Tensor, tp):
    """``fn``'s output, its input gradient and its weights' gradients
    under the upstream gradient ``dy``."""
    p = {k: v.detach().requires_grad_() for k, v in p.items()}
    x = h.detach().requires_grad_()
    out = fn(model, p, x, tp)
    out.backward(dy)
    return out.detach(), x.grad, {k: v.grad for k, v in p.items()}


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in fp64."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def check_block(model, layer: int, block: str, h: torch.Tensor,
                dy: torch.Tensor, size: int, params: dict | None = None
                ) -> dict:
    """The whole ``block`` ("attention" or "mlp") of ``model``'s layer
    ``layer`` on ``h`` (B, S, D) against its ``size`` ranks' shares run
    one by one: the relative errors (over max|whole|) of the summed
    outputs (``out``), input gradients (``dx``) and weight gradients
    (``grads``, by name).  ``params`` (default: the layer's own
    tensors) gives the weights, in their type (an fp32 copy of a bf16
    model's, say)."""
    fn, names = BLOCKS[block]
    src = params if params is not None else model.layers[layer].tensors()
    p = {k: v for k, v in src.items() if k in names}
    defs = param_defs(model.cfg)["layers"][layer]
    out, dx, grads = _run(fn, model, p, h, dy, None)
    acc_out = torch.zeros_like(out, dtype=torch.float64)
    acc_dx = torch.zeros_like(dx, dtype=torch.float64)
    acc = {k: torch.zeros_like(g, dtype=torch.float64)
           for k, g in grads.items()}
    for r in range(size):
        local = local_params(defs, p, r, size)
        o, d, g = _run(fn, model, local, h, dy, TensorParallel(r, size))
        acc_out += o.double()
        acc_dx += d.double()
        for k, gk in g.items():
            # a split weight's gradient is its block's; a replicated
            # one's this rank's partial sum
            view = local_params(defs, {k: acc[k]}, r, size)[k]
            view += gk.double()
    return dict(out=_err(acc_out, out), dx=_err(acc_dx, dx),
                grads={k: _err(acc[k], grads[k]) for k in grads})
