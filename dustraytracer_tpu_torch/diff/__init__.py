"""Gradient checks (port of diff/)."""

from dustraytracer_tpu_torch.diff.fd import check_grads_vs_fd, fd_grad

__all__ = ["fd_grad", "check_grads_vs_fd"]
