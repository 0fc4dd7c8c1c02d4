from .replay import Experience, ReplayDB
from .collection import collect_trajectory
# The JAX package also exports the function ``train_nbp``, which there
# hides the submodule of that name; here the submodule stays reachable.
from .train_nbp import (
    PlateauScheduler,
    TrainState,
    init_train_state,
    train_epoch,
    validate,
)
from .driver import run_training_nbp
from .pretrain_scone import (
    PretrainSample,
    make_pretrain_sample,
    pretrain_scone_occ,
    pretrain_scone_vis,
)
from .train_macarons import MacaronsTrainState, train_macarons_online
from .depth_losses import (
    error_mask_from_disparity,
    photometric_loss,
    regularity_loss,
    ssim,
)
