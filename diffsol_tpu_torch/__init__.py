"""diffsol_tpu_torch: the PyTorch and CUDA port of ``diffsol_tpu``.

The JAX package ``diffsol_tpu`` is the reference; this package mirrors its
module names and public layouts.  Plain tensor code is eager PyTorch in
float64, or float32 for a problem built with ``OdeBuilder.dtype``, and
every Pallas kernel of the covered paths is CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use: the fused small-n and
banded BDF whole-solve kernels and the band LU factor and solve (a double
and a float build; the solve also takes every sensitivity row against
its member's factors in one launch, and forward mode passes through
both).

The port so far covers the stiff BDF ensemble main path, the banded
method-of-lines tier and the single-instance solver surface up to the
adjoints: problems with identity, diagonal or dense mass (semi-
explicit DAEs with consistent initial conditions solved for) and an
optional user Jacobian (``rhs_implicit``), root events that stop the
solve or reset and continue, outputs and their quadrature; the BDF solver
on the dense, banded and block-diagonal linear-solver tiers, the SDIRK
(``tr_bdf2``, ``esdirk34``) and explicit RK (``tsit45``) solvers and
``solver``/``METHODS``; ``solve_dense`` and ``solve``, and
``solve_dense_ensemble`` in lockstep, independent and fused modes, on the
card unless the caller asks for the CPU.  Forward sensitivities come two
ways: the continuous sensitivity equations (``sens=True`` on any of the
three solvers, ``augmented.SensEquations``; ``Solution.sens``) on the
dense, block-diagonal and banded tiers, lockstep ensembles included, and
``solve_dense_fwd_sens``, forward mode through the solve (through the
band LU kernels on the banded tier).  Gradients come
from the adjoint: ``make_differentiable_solve`` and
``make_differentiable_quadrature`` and their ensemble forms
(``make_differentiable_solve_ensemble``, lockstep or independent, and
``make_differentiable_quadrature_ensemble``) return callables whose
``torch.autograd.Function`` runs the backward pass, with the dense step
table or bounded-memory checkpoints, output jumps, singular-mass DAEs and
reset-event corrections; a banded lockstep forward pass runs the band LU
kernels on the card.  Models may also come as DiffSL
text (``compile_diffsl``, ``OdeBuilder.build_from_diffsl`` and
``build_from_eqn``), with the ``N`` built-in's index-aware reset
(``reset_n``); their callables are plain torch, so they reach every solver
and both fused kernels.  Stochastic ODEs go through ``solvers.sde``
(Euler-Maruyama, Milstein, path ensembles, noise classification) with an
explicit ``torch.Generator``; ``utils.stats_dict``/``stats_json`` and
``Solution.raise_for_status`` are the API surface around a solve.
"""

from . import errors  # noqa: F401
from .adjoint import (  # noqa: F401
    make_differentiable_quadrature,
    make_differentiable_solve,
)
from .adjoint_ensemble import (  # noqa: F401
    make_differentiable_quadrature_ensemble,
    make_differentiable_solve_ensemble,
)
from .diffsl import DiffslModel, compile_diffsl  # noqa: F401
from .drivers import Solution, solve, solve_dense  # noqa: F401
from .ensemble import make_lockstep_problem, solve_dense_ensemble  # noqa: F401
from .equations import OdeEquations, make_equations  # noqa: F401
from .factory import METHODS, solver  # noqa: F401
from .sens import solve_dense_fwd_sens  # noqa: F401
from .problem import (  # noqa: F401
    InitialConditionOptions,
    OdeBuilder,
    OdeProblem,
    OdeSolverOptions,
    SolverConfig,
)
from .solvers import (  # noqa: F401
    BdfSolver,
    ErkSolver,
    SdirkSolver,
    Tableau,
    esdirk34,
    tr_bdf2,
    tsit45,
)

__version__ = "0.1.0"
