from .nbp_planning import NBPPlanningRollout, RolloutResult, test_nbp_planning
from .random_walk import random_walk_rollout
from .macarons_nbv import macarons_nbv_rollout
from .object_nbv import object_nbv_rollout, visible_mask
