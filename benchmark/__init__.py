"""The benchmark of the PyTorch/CUDA port (`custom_d_fine_tpu_torch`).

One command runs one cell of BENCHMARK.json:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: configurations in `configs/<name>.json`,
traffic mixes (data) in `traffic/<name>.json`, the runner of a mix's `kind`
in `runners/<kind>.py`, and each per-layer metric's reader in
`metrics/<name>.py`. `reference/` holds the plain PyTorch yardstick that
decides `correct`; it imports nothing of the port. Nothing here imports JAX
or the JAX package.
"""
