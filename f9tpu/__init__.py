"""f9tpu — accelerator-native batch audio resampling framework.

A from-scratch JAX/XLA re-design of the capabilities of
F9-Audio/F9-JUCE-Resampler-Studio: the studio app's analog hardware loop is
replaced by a software SRC core (polyphase windowed-sinc / Lagrange) running on
an NVIDIA GPU, with the app's batch-pipeline semantics preserved — job scheduling,
latency measurement & trimming, reverb-tail (noise-floor) termination,
multichannel routing, monitoring/preview analysis, WAV/AIFF decode/encode, and
per-file status/progress/logging.  See SURVEY.md at the repo root.
"""

from .version import __version__  # noqa: F401
from .config import ProcessingConfig  # noqa: F401
