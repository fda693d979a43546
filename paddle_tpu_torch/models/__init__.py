"""Model builders of the port: the fluid-style BERT encoder and the
transformer blocks it is built from, and the RNN slice's programs."""

from . import transformer  # noqa: F401
from . import bert         # noqa: F401
from . import rnn          # noqa: F401
