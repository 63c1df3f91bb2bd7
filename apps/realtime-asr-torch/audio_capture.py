"""Audio capture backends of chunkformer_tpu_torch, re-exported at the
reference's app layout (the twin of apps/realtime-asr/audio_capture.py).

The implementation lives in ``chunkformer_tpu_torch.data.capture``; this
module keeps the reference's file layout (apps/realtime-asr/audio_capture.py)
so the realtime app reads the same way.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from chunkformer_tpu_torch.data.capture import (  # noqa: F401,E402
    AudioFileSimulator,
    CaptureBase,
    FileSimulator,
    PyAudioCapture,
    SoundDeviceCapture,
    list_input_devices,
    open_capture,
)
