"""Runnable examples, the port's twins of ``examples/*.py``:
``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.simulate_sycamore``,
``python -m repro_torch.examples.serve_lm`` and
``python -m repro_torch.examples.train_lm``."""
