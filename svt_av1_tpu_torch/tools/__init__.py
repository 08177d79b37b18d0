"""The port's twins of the repo's tools (``tools/*.py`` of the JAX
package): the high-resolution operating points, the traced encode, the
RD dashboard and the QP-ladder experiment, each run as
``python -m svt_av1_tpu_torch.tools.<name>``."""
