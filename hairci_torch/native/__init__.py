"""Native host code of the port, built with g++ on first use: ``imageio``,
the C++ batch image decoder, and ``flatindex``, the host flat index
(``NativeFlatIndex``); the port's own copies of ``hairci/native/``."""

from hairci_torch.native.flatindex import METRIC_IP, METRIC_L2, NativeFlatIndex
