"""The paper's optimization framework: GP solver + GIA/CGP (Algorithms 2-5).

The solver engine is batched and backend-pluggable: problems sharing one
structure signature (same objective m, family varmap, worker count) pack into
fixed-shape systems (:mod:`repro_torch.opt.structure`) that either the NumPy
reference interior point (on the host, the same float64 operations in the
same order as the JAX package's, so its Plans are equal field for field) or
the batched torch interior point (:mod:`repro_torch.opt.gp_batched`) solve
whole batches of at once — ``solve_param_opt_batched`` is the lockstep GIA
over such a batch.  ``backend="torch-fused"`` goes all the way: the
surrogate coefficient refresh itself runs on the device
(:mod:`repro_torch.opt.refresh` builds a static per-signature refresh plan
from the skeleton) and the entire GIA — condensation, phase-I/Newton
interior point, convergence/stall masks — is one step program per
structure signature, captured as a CUDA graph on the card and replayed in
chunks (:mod:`repro_torch.opt.gia_fused`), with one host read per chunk.
"""
from .posy import Posy, const, var, monomial
from .gp import (GP, GPResult, BatchedGPResult, GP_BACKENDS,
                 register_gp_backend, solve_gp, solve_gp_batch)
from .condense import amgm_monomial, ratio_to_posy
from .problems import (Objective, ParamOptProblem, VarMap, identity_varmap,
                       pm_varmap, fa_varmap, pr_varmap)
from .structure import GPStructure, PackedBatch, structure_signature
from .refresh import RefreshPlan
from .gia import (GIAResult, min_feasible_K0, min_feasible_K0_joint,
                  solve_param_opt, solve_param_opt_batched)
