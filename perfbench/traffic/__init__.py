"""One module per kind of traffic. A workload file (perfbench/workloads/<cell>.json)
names its kind and parameters; the module builds the cell's inputs from the
seed, drives the program's timed entry, and runs the plain reference on the
same inputs.

Each kind module has `setup(run) -> driver`, `reference(run, tf32) -> outputs`
and `compare(prog_outputs, ref_outputs) -> {number: value}`. A driver has
`unit` (work items a step completes), `warm()`, `step()`, `sync()`,
`outputs()`, `failed()` and `release()`.
"""
