"""Planners.  This port has the staged one-shot pipeline
(:func:`oneshot_plan`); the anytime path–slice co-optimizer is not ported
yet."""

from .search import OneShot, oneshot_plan

__all__ = ["OneShot", "oneshot_plan"]
