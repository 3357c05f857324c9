"""The benchmark's plain reference of the path tracer: plain PyTorch,
written from the renderer's documented semantics, importing nothing of
the program. It takes the triangle soup, materials, texture, lights and
cameras that the benchmark generates, builds its own traversal chunks,
and computes in the dtype it is given (float32; bfloat16 is the
control)."""
