"""Tensor ops of the port: graph building, VQ, normalisation, and the
hand-written CUDA kernels under ``ops.kernels``."""

from .geometry import pairwise_point_sim
from .graph import (
    InstanceSlots,
    clamp_softmax,
    compact_instance_slots,
    graph_dtype,
    instance_edges,
    instance_vertices,
)
from .normalize import normalize_max, normalize_sum, normalize_sum_clamp, safe_softmax
from .vq import vq_assign, vq_encode
