"""What ``chip_smoke.py``'s card checks compare, held on the CPU.

The train phase's card-against-CPU agreement runs each side's last step
with ``_metrics_only`` in place of the optimizer's update: the loss and
grad norm it compares are the full step's to the bit, and the state no
check reads is left as it was (qwen3-4b's shrink, fp32).
"""

import contextlib
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.launch.train import train_batch, train_dataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import init_state, make_train_step  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def test_last_step_metrics_without_the_update():
    cfg = smoke_shrink(get_config("qwen3-4b"))
    batch = train_batch(cfg, train_dataset(cfg, 32, 2, seed=0), 0)
    ocfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                               total_steps=2)
    runs = {}
    for metrics_only in (False, True):
        model = build_model(cfg, seed=0, device="cpu").to(torch.float32)
        state = init_state(model, ocfg)
        before = [t.clone() for t in tree.leaves((state.params, state.opt))]
        with (cs._patched(opt, {"update": cs._metrics_only(opt)})
              if metrics_only else contextlib.nullcontext()):
            after, met = make_train_step(model, ocfg)(state, batch)
        runs[metrics_only] = ({k: float(v) for k, v in met.items()}, before,
                              tree.leaves((after.params, after.opt)))
    assert runs[True][0] == runs[False][0]
    # the full step moved the weights and the moments; the last step's
    # metrics left every parameter, moment and the update count as they
    # were
    assert any(not torch.equal(a, b) for a, b in zip(*runs[False][1:]))
    assert all(torch.equal(a, b) for a, b in zip(*runs[True][1:]))
