"""Sharding: logical axes on every parameter, cache and input, resolved
against a mesh description (:mod:`repro_torch.parallel.sharding`)."""
