"""The benchmark of the PyTorch / CUDA port (dustraytracer_tpu_torch):
render and inverse-rendering cells run by `python3 -m bench_port.run`."""
