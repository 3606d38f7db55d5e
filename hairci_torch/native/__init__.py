"""Native host code of the port: ``imageio``, the C++ batch image decoder
(the port's copy of ``hairci/native/imageio.{cpp,py}``), built with g++ on
first use."""
