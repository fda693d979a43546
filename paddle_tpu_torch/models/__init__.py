"""Model builders of the port: the fluid-style BERT encoder and the
transformer blocks it is built from."""

from . import transformer  # noqa: F401
from . import bert         # noqa: F401
