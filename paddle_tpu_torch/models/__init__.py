"""Model builders of the port: the fluid-style BERT encoder and the
transformer blocks it is built from, the RNN slice's programs, ResNet
and VGG (``resnet``, ``vgg``, imported on use), and the named program
zoo (``zoo``)."""

from . import transformer  # noqa: F401
from . import bert         # noqa: F401
from . import rnn          # noqa: F401
