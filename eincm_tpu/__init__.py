"""eincm_tpu — Edge-Informed Contrast Maximization in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA framework for model-based event-camera optical flow
estimation with the capabilities of
robotic-vision-lab/Edge-Informed-Contrast-Maximization (WACV 2025):

- The hot warp+splat is the reference's scatter-add of a 3x3 Gaussian
  window per event (src/utils/event_utils.py:42-59), left to XLA.
- The BFGS optimization loop runs entirely on device under `jit`
  (reference: host-side scipy via jaxopt, src/eincm/solver.py:165-183).
- Event windows shard over a `jax.sharding.Mesh` via `shard_map`
  (reference: single-device sequential loop, src/experiments/e00/exp_mgr.py:620).

Top-level API:

    from eincm_tpu import (
        SolverConfig, HandoverSettings, WindowSample, solve_window,
        make_window_solver, LossParams, ExperimentConfig, EINCMExperiment,
    )
"""

__version__ = "0.1.0"

from eincm_tpu.models.loss import LossParams, LossStatics
from eincm_tpu.models.pyramid import (
    HandoverSettings,
    SolveResult,
    SolverConfig,
    WindowSample,
    make_window_solver,
    solve_window,
)


def __getattr__(name):
    # heavier layers load lazily so `import eincm_tpu` stays light
    if name in ("ExperimentConfig", "load_config"):
        from eincm_tpu.experiments import config as _c

        return getattr(_c, name)
    if name == "EINCMExperiment":
        from eincm_tpu.experiments.manager import EINCMExperiment

        return EINCMExperiment
    raise AttributeError(name)
