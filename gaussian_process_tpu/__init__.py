"""gaussian_process_tpu — a Gaussian-process inference engine for NVIDIA GPUs.

A from-scratch JAX/XLA + Pallas + pjit/shard_map framework covering the
capabilities of the reference repo ``happyjin/Gaussian_process``:

- exact GP regression (Rasmussen & Williams Alg. 2.1)
  [ref: GP_regression.py:109-156]
- GP prior/posterior sampling  [ref: GP_regression.py:71-106]
- Laplace-approximation binary GP classification (R&W Alg. 3.1/3.2)
  [ref: GP_binary_classification.py:86-154]
- multi-class Laplace GP classification (R&W Alg. 3.3, block structure)
  [ref: GP_multi_classification.py:66-197]
- log-marginal-likelihood hyperparameter tuning via jax.grad + optax
  [ref: tune_hyperparms_regression.py:31-162]
- Bayesian-optimization hyperparameter tuning with PI/EI/UCB/TS acquisitions
  [ref: tune_hyperparms_regression.py:165-289, CO2_example.py:217-314]
- the Mauna Loa CO2 composite kernel (GPML sec. 5.4.3)
  [ref: CO2_example.py:9-94]

Architecture (bottom-up): ``ops`` (pairwise-distance / kernel-matrix
primitives and the matrix-free kernel matvec, incl. a Pallas GPU kernel)
-> ``linalg`` (jittered Cholesky,
triangular solves, preconditioned CG) -> ``gp`` (regression + Laplace
classification) -> ``opt`` (LML gradient ascent, Bayesian optimization) ->
``parallel`` (mesh / sharding / collectives for multi-chip scale-out) ->
``utils`` (configs, datasets, logging, checkpointing).
"""

__version__ = "0.1.0"

from gaussian_process_tpu import ops  # noqa: F401
from gaussian_process_tpu import linalg  # noqa: F401
from gaussian_process_tpu import gp  # noqa: F401
from gaussian_process_tpu import opt  # noqa: F401
from gaussian_process_tpu import models  # noqa: F401
from gaussian_process_tpu import parallel  # noqa: F401
from gaussian_process_tpu import utils  # noqa: F401
