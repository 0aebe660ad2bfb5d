"""Load testing: recipe-driven QPS schedules and a self-contained
loadtest (target server + doorman-limited workers).

Capability parity with reference go/client/recipe/recipe.go and
doc/loadtest/docker/{client,target}.

Port of doorman_tpu/loadtest/__init__.py: a copy apart from import paths.
"""

from doorman_tpu_torch.loadtest.recipe import (
    Recipe,
    RecipeError,
    WorkerState,
    parse_recipes,
)

__all__ = ["Recipe", "RecipeError", "WorkerState", "parse_recipes"]
