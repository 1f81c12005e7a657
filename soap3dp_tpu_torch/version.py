"""Version of the soap3dp_tpu framework.

The reference tracks its version in Release.h:27-35 (v2.3.178); this
rebuild starts its own versioning.
"""

__version__ = "0.3.0"
