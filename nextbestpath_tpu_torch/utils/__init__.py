from .checkpoint import load_checkpoint, save_checkpoint
from .schedules import noam_schedule, warmup_constant_schedule, warmup_exponential_schedule
from .debugging import BadLossGuard, anomaly_detection, check_gradients
from .fastloader import FastArrayLoader
