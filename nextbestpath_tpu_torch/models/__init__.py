from .unet import NBP, nbp_loss
# The JAX package also exports the function ``attention``, which there
# hides the submodule of that name; here the submodule stays reachable.
from .attention import Embedding, Encoder, FeedForward, MultiHeadSelfAttention
from .scone import PCTransformer, SconeOcc, SconeVis, XEmbedding, coverage_gain, visibility_gains
from .harmonics import base_view_harmonics, harmonics_up_to_rank, spherical_harmonics
from .manydepth import ManyDepth, depth_to_disparity, disparity_to_depth
from .macarons import Macarons, macarons_optimizer
