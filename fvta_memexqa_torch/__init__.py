"""PyTorch/CUDA port of fvta_memexqa_tpu for NVIDIA Hopper (H100).

The serving path: pack → FVTAModel.encode_context (album cache) →
FVTAModel.answer; the training path: cli train → train.train (optimizer in
optim.py, checkpoints in checkpoint.py); the video path: cli video →
train_video.train_video, cli video-test (models/video.py, data/video_pack.py).
Hand-written CUDA kernels: the bi-LSTM forward (csrc/lstm_fwd.cu) and backward
(csrc/lstm_bwd.cu), the fused FVTA attention forward (csrc/fvta_fwd.cu), and
for long T the streaming FVTA statistics (csrc/fvta_stats.cu) with their
backward pair (csrc/fvta_bwd.cu). On a CUDA tensor the ops launch the
kernels; on a CPU tensor they run the plain PyTorch versions. The package
imports neither JAX nor fvta_memexqa_tpu.
"""

from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig

__all__ = ["Config", "DataConfig", "ModelConfig"]
