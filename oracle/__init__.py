"""NumPy oracle: slow, float64, host-side implementations of the reference
pipelines' behaviors (see SURVEY.md §2.3-2.5). Written from scratch against
the reference's *math* — these are the golden fixtures the JAX framework is
tested against, and the CPU baseline the benchmarks are measured against."""

from oracle.pipeline import (
    echo_monostatic,
    echo_bistatic,
    echo_spotlight,
    add_ocean_noise,
    snr_db_radar_equation,
    hamming,
    focus_rda,
    focus_csa,
    focus_tdbp,
)
