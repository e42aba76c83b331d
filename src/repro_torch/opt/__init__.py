"""The paper's optimization framework: GP solver + GIA/CGP (Algorithms 2-5).

The scalar NumPy reference engine, the same float64 operations in the same
order as the JAX package's, so the Plans it produces are equal field for
field.  The batched and fused device solvers are not ported yet (ROADMAP
Queue 1, item 7).
"""
from .posy import Posy, const, var, monomial
from .gp import GP, GPResult, solve_gp
from .condense import amgm_monomial, ratio_to_posy
from .problems import (Objective, ParamOptProblem, VarMap, identity_varmap,
                       pm_varmap, fa_varmap, pr_varmap)
from .gia import (GIAResult, min_feasible_K0, min_feasible_K0_joint,
                  solve_param_opt)
