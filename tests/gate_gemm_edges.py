"""Edge shapes of the gate GEMM's tile (``csrc/gate_gemm.cu``, the body of
K1f, K3f and K4f, K2f's conv 2 and K12f's head) and of K2f's first stage
(``csrc/vertex_fused.cu`` ``tail_h_kernel``), shared by the card tests
(``test_torch_kernels_cuda.py``, kernel against plain version) and their
CPU twins (``test_torch_vertex_fused.py``, ``test_torch_output_head.py``,
plain version against the JAX reference). Gate widths straddle the tile's
64- and 128-channel passes; contraction rows (kt·c_in) its 16-row pieces;
t_in = kt leaves one output step; narrow outputs 1, 5 and 16; batch 1-3; Vp
one to three 128-lane tiles, the last holding padded lanes. Plain data: the
card file imports no JAX."""

# K1f: act, c0, c_in, kt, t_in, c1, apply_ln, input dropout, batch, v_pad
HEAD_EDGES = [
    ("glu", 16, 1, 3, 12, 16, False, False, 1, 128),
    ("gtu", 64, 3, 2, 2, 5, True, True, 2, 384),
    ("relu", 100, 65, 3, 3, 1, True, True, 1, 384),
    ("silu", 128, 64, 1, 4, 16, True, False, 1, 128),
    ("glu", 130, 65, 3, 5, 16, True, True, 1, 128),
    ("relu", 64, 64, 2, 6, 16, False, False, 2, 128),
    ("silu", 130, 3, 3, 4, 5, False, False, 1, 384),
    ("gtu", 128, 1, 1, 1, 1, False, False, 1, 128),
    ("glu", 100, 64, 2, 3, 5, True, True, 3, 256),
    ("relu", 16, 3, 1, 2, 16, True, True, 1, 128),
]

# K4f: c0 (fc1's input channels), c1 (fc1 width: the tile's channels),
# c_end (fc2 outputs), dropout after the ReLU, batch, v_pad
OFC_EDGES = [
    (64, 128, 1, True, 1, 128),
    (3, 130, 16, False, 1, 384),
    (65, 100, 5, True, 2, 384),
    (1, 16, 1, False, 1, 128),
    (128, 64, 16, True, 1, 128),
]


# K2f: act, graph conv type, Ks (n_c: graph_conv 1, Chebyshev Ks 2 and 3),
# c1 (h channels: conv 2's rows a tap), c2 (gate width), kt, t1 (t1 = kt:
# one output step), batch, v_pad
TAIL_EDGES = [
    ("glu", "cheb_graph_conv", 3, 16, 64, 3, 10, 2, 256),
    ("gtu", "graph_conv", 3, 5, 16, 1, 1, 1, 128),
    ("relu", "cheb_graph_conv", 2, 1, 100, 2, 2, 3, 384),
    ("silu", "cheb_graph_conv", 3, 16, 128, 3, 3, 1, 128),
    ("glu", "graph_conv", 3, 16, 130, 2, 10, 1, 384),
    ("relu", "cheb_graph_conv", 3, 5, 64, 3, 10, 2, 128),
    ("gtu", "cheb_graph_conv", 2, 16, 16, 3, 3, 1, 256),
    ("silu", "graph_conv", 3, 1, 130, 1, 10, 3, 128),
    ("glu", "cheb_graph_conv", 2, 5, 100, 1, 10, 1, 256),
    ("relu", "graph_conv", 3, 16, 128, 2, 2, 2, 384),
]

# K3f: act, c0 (gate width), c_in, ko (taps: the output head's time steps),
# input dropout, batch, v_pad
OHEAD_EDGES = [
    ("glu", 128, 64, 4, True, 2, 256),
    ("gtu", 16, 1, 1, False, 1, 128),
    ("relu", 100, 65, 2, True, 3, 384),
    ("silu", 130, 3, 4, False, 1, 128),
    ("glu", 64, 64, 1, True, 1, 384),
    ("relu", 128, 1, 4, False, 2, 128),
    ("gtu", 130, 65, 2, True, 1, 256),
    ("silu", 64, 3, 2, True, 3, 256),
    ("glu", 100, 3, 1, False, 2, 128),
]


def v_true_of(v_pad: int) -> int:
    """True lanes of a case: the last 128-lane tile holds padded lanes."""
    return v_pad - 37
