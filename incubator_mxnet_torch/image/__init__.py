"""``mx.image``: image decode, augmenters and ``ImageIter``, and the
detection augmenters and ``ImageDetIter`` (counterpart of the JAX
package's ``image/``)."""
from .image import *  # noqa: F401,F403
from .image import __all__ as _image_all
from .detection import *  # noqa: F401,F403
from .detection import __all__ as _detection_all

__all__ = list(_image_all) + list(_detection_all)
