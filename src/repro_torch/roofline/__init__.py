"""repro_torch.roofline — roofline arithmetic against the H100
(``repro/roofline``): :mod:`.analysis` (the terms, the encode byte model)
and :mod:`.report` (the dry-run and roofline tables)."""
