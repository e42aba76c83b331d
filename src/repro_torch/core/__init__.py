"""The paper's primary contribution: GenQSGD + its convergence/cost models.

Layers:
  step_rules   — constant / exponential / diminishing Γ generators
  convergence  — C_A / C_C / C_E / C_D closed forms (Theorem 1, Lemmas 1-3)
  cost         — T(K,B), E(K,B) heterogeneous-system cost models
  genqsgd      — Algorithm 1 in PyTorch (the single-process runtime)
"""
from ..compress import (bits_per_message, make_codec, q_pair, variance_bound)
from .step_rules import (ConstantRule, ExponentialRule, DiminishingRule,
                         StepRule, make_rule)
from .convergence import (MLProblemConstants, coefficients, c_arbitrary,
                          c_constant, c_exponential, c_diminishing, c_m)
from .cost import EdgeSystem, time_cost, energy_cost
from .genqsgd import GenQSGD, GenQSGDConfig, flatten_like, unflatten_like
