"""Hyper-parameter search (counterpart of `miseg_tpu/hpo/`): pure Python
and numpy, the same samplers, pruners and study journal as the JAX
package, so the same history gives the same suggestions and a journal
that one package began the other resumes."""

from .study import Study, Trial, TrialPruned, create_study  # noqa: F401
from .samplers import TPESampler, RandomSampler  # noqa: F401
from .pruners import SuccessiveHalvingPruner, NopPruner  # noqa: F401
