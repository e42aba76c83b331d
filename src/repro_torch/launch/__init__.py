"""repro_torch.launch — the command lines and the per-case analyses
(``repro/launch``): :mod:`.train` (federated LM training), :mod:`.specs`
(every arch × input shape as a step function over fake tensors),
:mod:`.dryrun` (bytes against one card), :mod:`.roofline` and :mod:`.perf`
(FLOPs and bytes against the H100's roofline).

``repro``'s ``launch/mesh.py`` has no counterpart: it builds the GSPMD
production meshes, and the port runs a case on one card.
"""
