"""The plain reference: float32 PyTorch with TF32 off in cuBLAS and cuDNN.

Frozen copies of the port's plain versions (fvta_memexqa_torch/ops/lstm_ref.py,
ops/fvta_ref.py, ops/masking.py, models/embed.py, models/fvta.py,
optim.py, train.masked_choice_metrics) written as functions of
a parameter dict. It imports neither JAX nor anything of fvta_memexqa_torch, and
takes nothing the program made: weights and inputs come from the benchmark's
seed, and the reference works out again whatever the program derives from
them (the vocabulary and photo tables, the album cache, the optimizer state).
"""
