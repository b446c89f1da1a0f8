"""Decoder-tree visualization, a copy of polar_codes_tpu/tools/visualize.py
on the port's construction and code tree: the Fast-SSC specialised node
tree of an (N, K, design SNR) code as text, or as a matplotlib figure
(matplotlib is imported only by render_tree_figure)."""

from __future__ import annotations

from ..construction import frozen_bits
from ..models.tree import CodeNode, NodeKind, build_tree


_COLORS = {
    NodeKind.RATE0: "#9e9e9e",
    NodeKind.RATE1: "#2b6cb0",
    NodeKind.REP: "#38a169",
    NodeKind.SPC: "#d69e2e",
    NodeKind.ENUM: "#805ad5",
    NodeKind.BRANCH: "#e2e8f0",
}


def specialized_tree(
    block_length: int, info_length: int, design_snr: float = 0.0,
    constructor: str = "BB", enum_span: int = 0, max_enum_k: int = 0,
) -> CodeNode:
    frozen = frozen_bits(block_length, info_length, design_snr, constructor)
    return build_tree(
        block_length, frozen, enum_span=enum_span, max_enum_k=max_enum_k
    )


def render_tree_text(
    block_length: int, info_length: int, design_snr: float = 0.0,
    constructor: str = "BB",
) -> str:
    """Indented node dump (PCTree's data, textual)."""
    return specialized_tree(
        block_length, info_length, design_snr, constructor
    ).describe()


def render_tree_figure(
    block_length: int, info_length: int, design_snr: float = 0.0,
    constructor: str = "BB", path: str = None,
    enum_span: int = 0, max_enum_k: int = 0,
):
    """Draw the specialized tree; one box per node, colored by kind."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    tree = specialized_tree(
        block_length, info_length, design_snr, constructor,
        enum_span=enum_span, max_enum_k=max_enum_k,
    )
    depth_max = (block_length).bit_length()
    fig, ax = plt.subplots(figsize=(12, 1 + depth_max))

    def draw(node: CodeNode, depth: int):
        x0 = node.offset / block_length
        w = node.length / block_length
        ax.add_patch(
            Rectangle(
                (x0, -depth), w * 0.98, 0.8,
                facecolor=_COLORS[node.kind], edgecolor="black", lw=0.3,
            )
        )
        if node.length >= block_length / 32:
            ax.text(
                x0 + w / 2, -depth + 0.4, f"{node.kind.value}\n{node.length}",
                ha="center", va="center", fontsize=6,
            )
        if node.kind == NodeKind.BRANCH:
            draw(node.left, depth + 1)
            draw(node.right, depth + 1)

    draw(tree, 0)
    ax.set_xlim(0, 1)
    ax.set_ylim(-depth_max - 0.5, 1)
    ax.axis("off")
    ax.set_title(
        f"Fast-SSC tree N={block_length} K={info_length} "
        f"dSNR={design_snr} ({constructor})"
    )
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig
