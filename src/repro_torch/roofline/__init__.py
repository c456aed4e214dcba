"""The roofline: analytic FLOPs and HBM bytes of each (arch x shape)
cell (:mod:`.analytic`) and the three-term bound on the H100
(:mod:`.analysis`)."""
