"""The benchmark of the PyTorch/CUDA port (fvta_memexqa_torch): one command,
`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`,
driven by the files under this folder (see run.py)."""
