from .resample import (  # noqa: F401
    banded_rows_plan,
    marshal_banded_rows,
    resample,
    resample_auto,
    resample_banded,
    resample_banded_rows_pre,
    resample_gather,
    resample_rates,
    resample_rows,
    resample_rows_pre,
    rows_marshal_plan,
)
from .analysis import (  # noqa: F401
    rms, rms_db, peak, peak_db, noise_floor_db, peak_position, first_above,
    remove_dc_offset,
)
from .dither import tpdf_dither_quantize, quantize, dequantize  # noqa: F401
from .trim import (  # noqa: F401
    trim_latency, pad_tail, detect_tail_end, mask_beyond, interleaved_to_frames,
)
from .signal import sine, impulse, log_sweep  # noqa: F401
from .routing import (  # noqa: F401
    stereo_pairs, route_channels, fan_out_mono, mixdown_monitor, interleave,
    deinterleave,
)
from .chain import (  # noqa: F401
    Biquad, Chain, Compressor, Expander, Gain, Delay, FIRInsert,
    ConvolutionReverb, Limiter, Saturator, StereoWidth, fft_convolve,
)
from .loudness import (  # noqa: F401
    integrated_lufs, k_weighting_ir, loudness_range, true_peak_db,
)
