"""``mx.image``: image decode, augmenters and ``ImageIter`` (counterpart of
the JAX package's ``image/``).  The detection augmenters and
``ImageDetIter`` (its ``image/detection.py``) wait in ROADMAP §1 item 10
with the detection family, and raise at access naming it."""
from .image import *  # noqa: F401,F403
from .image import __all__ as _image_all

__all__ = list(_image_all)

_DETECTION = ("DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug", "DetRandomCropAug",
              "CreateDetAugmenter", "ImageDetIter")


def __getattr__(name):
    if name in _DETECTION:
        raise AttributeError(f"mx.image.{name} is not ported yet: it waits in ROADMAP §1 item "
                             "10 with the detection family")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
