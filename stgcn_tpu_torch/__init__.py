"""stgcn_tpu_torch — the PyTorch / CUDA port of ``stgcn_tpu`` for one NVIDIA
H100.

It carries the forecast and training paths: the GSO and data pipeline, the
unfused STGCN, the vertex-fused forward through four hand-written Hopper
kernels (K1 head, K2 tail, K3/K4 output head) and their backward kernels
(K1b-K4b), element-keyed dropout, the optimizers and the ``Trainer``; above
4096 vertices the banded graph operator with its kernel K5, and for the
1M-vertex graph the blocked-ELL operator with its kernel K6 and the BCSR
operator (what ``make_graph_op("auto")`` picks there) with its SpMM K10 and
SDDMM K11; and the CLI
(``python -m stgcn_tpu_torch.cli``). Entry points take ``device=``, which
defaults to ``"cuda"``; the CPU runs only when asked for. The package
imports no JAX and nothing of ``stgcn_tpu``.
"""

from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler, gather_windows, load_adj, load_vel  # noqa: F401
from stgcn_tpu_torch.graph import GraphShiftOperator, build_gso  # noqa: F401
from stgcn_tpu_torch.nn import STGCN  # noqa: F401
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward  # noqa: F401
from stgcn_tpu_torch.ops import BandedGraphOp, DenseGraphOp, make_graph_op  # noqa: F401
from stgcn_tpu_torch.train import TrainConfig, Trainer, evaluate_metrics  # noqa: F401
