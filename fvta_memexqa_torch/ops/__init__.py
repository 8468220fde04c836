from fvta_memexqa_torch.ops.masking import VERY_NEGATIVE, exp_mask, masked_softmax
from fvta_memexqa_torch.ops.lstm_ref import LSTMParams, bilstm_ref, lstm_scan_ref
from fvta_memexqa_torch.ops.fvta_ref import (
    ATTENTION_VARIANTS,
    AttentionOutput,
    flat_attention,
    focal_finalize,
    focal_local_stats,
    fvta_attention,
    no_attention,
    similarity_tensor,
)
from fvta_memexqa_torch.ops.lstm_fused import (bilstm_fused, bilstm_fused_final, lstm_bwd,
                                               lstm_fwd)
from fvta_memexqa_torch.ops.fvta_fused import fvta_attention_fused, fvta_fwd
from fvta_memexqa_torch.ops.fvta_stats import fvta_stats_fused, qcnt, stats_bwd, stats_fwd

__all__ = [
    "VERY_NEGATIVE",
    "exp_mask",
    "masked_softmax",
    "LSTMParams",
    "bilstm_ref",
    "lstm_scan_ref",
    "ATTENTION_VARIANTS",
    "AttentionOutput",
    "flat_attention",
    "focal_finalize",
    "focal_local_stats",
    "fvta_attention",
    "no_attention",
    "similarity_tensor",
    "bilstm_fused",
    "bilstm_fused_final",
    "lstm_fwd",
    "lstm_bwd",
    "fvta_attention_fused",
    "fvta_fwd",
    "fvta_stats_fused",
    "stats_fwd",
    "qcnt",
    "stats_bwd",
]
