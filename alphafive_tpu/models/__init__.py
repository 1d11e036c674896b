"""Policy-value networks and evaluators (SURVEY.md §1 L3)."""

from alphafive_tpu.models.resnet import (apply, apply_eval, apply_train,
                                         init_variables)

__all__ = ["apply", "apply_eval", "apply_train", "init_variables"]
