from . import circuits, gates, statevector, xeb  # noqa: F401
