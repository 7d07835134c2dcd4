"""A frozen plain copy of the port's D-FINE model, criterion, matcher,
optimizer and EMA, with every CUDA kernel replaced by plain PyTorch: the MSDA
sampling is `ops/deform_attn.py:ms_deform_attn` (a gather per corner) and the
stem runs as the model's own convolutions. It is the yardstick the benchmark
holds the port against, and it imports nothing of the port: relative imports
resolve inside this copy. Module paths mirror the port's."""
