"""The benchmark's plain reference: the port's model code frozen as it was
when the benchmark was defined (`config.py`, `models/`, `ops/`,
`geometry/`, `pose/`, `tracking/graph_builder.py`), with its kernels'
plain versions in their place (`ops/plain_kernels.py`), and the serving
stages and training steps written out plainly (`steps.py`).

It imports no module of the program and no JAX.  The benchmark runs it in
float32 with TF32 off (`steps.true_fp32`)."""
