"""Fitting layer of the port: energy, initialization, staged solvers."""

from .energy import (
    EnergySpec,
    Observations,
    StageWeights,
    energy_terms,
    total_energy,
    residuals,
    pack,
    unpack,
    free_mask,
)
from .gradient import gradient_fit, GradientOptions
from .initialize import init_guess, warm_start, InitGuess
from .lbfgs import lbfgs_fit, LBFGSOptions
from .lm import lm_fit, LMOptions
from .stages import (
    FitConfig,
    FitResult,
    default_stages,
    fit_frame,
)
from .adjust import refit_with_observations
from .multi_person import fit_people
