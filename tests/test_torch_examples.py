"""The port's example twins (``repro_torch.examples``) at small CPU sizes:
each ``main()`` runs end to end (its own asserts hold it against the
port's statevector), and its amplitudes are held against what the
reference example's calls return from the JAX package on the same
circuit, at rtol 1e-4, atol 1e-5.  The serving twin draws its own random
weights (the reference's ``jax.random`` draws other numbers), so it is
held to the reference example's models, sizes and output shapes."""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import open_amplitude_batch as ref_batch  # noqa: E402
from repro.core import simulate_amplitude as ref_simulate  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch.examples import quickstart, serve_lm, simulate_sycamore  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def test_quickstart_twin(capsys):
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK" in out and "(hoist=False disables)" in out and "cache=hit" in out
    assert got["repeat_cache_hit"]
    # the reference example's calls, on the JAX package
    circ = ref_circuits.random_1d_circuit(n=10, cycles=8, seed=42)
    want = ref_simulate(circ, "0110100101", target_dim=5, method="lifetime",
                        backend="gemm")
    np.testing.assert_allclose(got["amplitude"], complex(np.asarray(want.value)),
                               rtol=RTOL, atol=ATOL)
    want2 = ref_simulate(circ, "1001011010", target_dim=5, backend="gemm")
    np.testing.assert_allclose(got["repeat_amplitude"],
                               complex(np.asarray(want2.value)), rtol=RTOL, atol=ATOL)
    batch, _ = ref_batch(circ, open_qubits=(7, 8, 9), target_dim=5, backend="gemm")
    np.testing.assert_allclose(got["batch"], batch.flat(), rtol=RTOL, atol=ATOL)


def test_simulate_sycamore_twin(capsys):
    args = ["--device", "cpu", "--rows", "3", "--cols", "3", "--cycles", "8",
            "--target-dim", "6", "--samples", "3", "--num-samples", "200",
            "--open-qubits", "3"]
    got = simulate_sycamore.main(args)
    out = capsys.readouterr().out
    for line in ("+ branch merging", "two-phase execution", "mixed precision",
                 "batch sampling"):
        assert line in out
    assert len(got["amplitudes"]) == 3
    circ = ref_circuits.sycamore_like(3, 3, 8, seed=0)
    for bs, amp in got["amplitudes"].items():
        want = ref_simulate(circ, bs, target_dim=6, backend="gemm")
        np.testing.assert_allclose(amp, complex(np.asarray(want.value)),
                                   rtol=RTOL, atol=ATOL)
    batch, _ = ref_batch(circ, open_qubits=(6, 7, 8), target_dim=6, backend="gemm")
    np.testing.assert_allclose(got["batch"], batch.flat(), rtol=RTOL, atol=ATOL)
    assert len(got["bitstrings"]) == 200


def test_serve_lm_twin(capsys):
    from repro.launch.decode_demo import serve as ref_serve

    got = serve_lm.main(["--device", "cpu"])
    assert tuple(got) == serve_lm.ARCHS == ("qwen3-4b", "mamba2-130m")
    # the hybrid through --arch, held to the reference's serve of it
    got.update(serve_lm.main(["--device", "cpu", "--arch", "zamba2-7b"]))
    out = capsys.readouterr().out
    for arch, r in got.items():
        assert arch in out
        want = ref_serve(arch, smoke=True, batch=4, prompt_len=64,
                         gen_tokens=24)
        assert r["generated"].shape == want["generated"].shape == (4, 24)
        assert ((r["generated"] >= 0) & (r["generated"] < 512)).all()
        assert r["prefill_s"] > 0 and r["decode_tok_per_s"] > 0


def test_twins_need_a_device_they_can_run_on():
    """Without a GPU the twins' default device raises instead of running
    on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for main in (quickstart.main, simulate_sycamore.main, serve_lm.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
