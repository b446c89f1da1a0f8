"""Host-side analysis and construction tools, NumPy copies of
polar_codes_tpu/tools/ on the port's construction and code tree: GF(2)
matrices and bit-reversal helpers, 5G NR rate matching, frozen-bit
strategy classes, noise calibration, the decoder tree as text or a
figure, and the results readers: the simulator's CSVs and benchmark grids
as curves, ratios and figures (analysis.py), and as one HTML report
(report.py, `render_report`)."""

from .code_tools import (
    polar_generator_matrix,
    systematic_encoder_matrix,
    bit_reverse,
    bit_reversed_vector,
    frozen_indices_to_map,
    info_indices_from_frozen,
)
from .fiveg_tools import (
    nr_subblock_interleave,
    nr_rate_match,
    nr_rate_recover,
)
from .strategies import (
    FrozenBitPositions,
    FrozenBitPositionsBB,
    FrozenBitPositionsBE,
    FrozenBitPositionsGA,
    FrozenBitPositions5G,
    get_frozen_bit_generator,
)
from .channel_tools import ebn0_to_sigma, sigma_to_ebn0, ebn0_to_esn0_linear
from .analysis import (read_results_csv, summarize_results,
                       merge_results, parse_bench_name,
                       load_benchmark_jsonl, compare_grids,
                       plot_bler_overlay, plot_fer_throughput_combo,
                       plot_grid_throughput)
from .visualize import render_tree_text, render_tree_figure

__all__ = [
    "polar_generator_matrix",
    "systematic_encoder_matrix",
    "bit_reverse",
    "bit_reversed_vector",
    "frozen_indices_to_map",
    "info_indices_from_frozen",
    "nr_subblock_interleave",
    "nr_rate_match",
    "nr_rate_recover",
    "FrozenBitPositions",
    "FrozenBitPositionsBB",
    "FrozenBitPositionsBE",
    "FrozenBitPositionsGA",
    "FrozenBitPositions5G",
    "get_frozen_bit_generator",
    "ebn0_to_sigma",
    "sigma_to_ebn0",
    "ebn0_to_esn0_linear",
    "read_results_csv",
    "summarize_results",
    "merge_results",
    "parse_bench_name",
    "load_benchmark_jsonl",
    "compare_grids",
    "plot_bler_overlay",
    "plot_fer_throughput_combo",
    "plot_grid_throughput",
    "render_tree_text",
    "render_tree_figure",
]
