"""Constructor-struct style configs (reference keeps library config in structs
like BatchSize / create_aligner arguments; we mirror that with dataclasses so
the library stays importable without the CLI.
Reference: cudapoa/include/claragenomics/cudapoa/batch.hpp [U],
cudaaligner/include/claragenomics/cudaaligner/aligner.hpp [U],
cudamapper/src/application_parameters.cpp [U]).
"""

from dataclasses import dataclass, field


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class AlignerConfig:
    """Static-shape plan for one aligner batch.

    The reference sizes device slabs from (max_query_length,
    max_target_length, max_alignments); here the same numbers become the
    padded array shapes of one XLA program.
    """

    max_query_length: int
    max_target_length: int
    max_alignments: int
    # Band radius for banded ("Ukkonen") NW: cells with |i - j| > band_radius
    # are outside the band.  Must be >= |len(q) - len(t)| for a global path to
    # exist; alignments violating that get EXCEEDED_MAX_ALIGNMENT_DIFFERENCE.
    band_radius: int = 64

    @property
    def band_width(self) -> int:
        """Number of band cells per DP row of the XLA twin, padded to 128."""
        return _round_up(2 * self.band_radius + 1, 128)

    @property
    def padded_query_length(self) -> int:
        return _round_up(self.max_query_length, 8)

    @property
    def padded_target_length(self) -> int:
        return _round_up(self.max_target_length, 8)


@dataclass(frozen=True)
class PoaScores:
    """POA alignment scores (reference defaults: gap -8, mismatch -6, match 8;
    reference: cudapoa create_batch defaults [U])."""

    match_score: int = 8
    mismatch_score: int = -6
    gap_score: int = -8


@dataclass(frozen=True)
class BatchSize:
    """Static capacity plan for one POA batch
    (reference: cudapoa/include/claragenomics/cudapoa/batch.hpp BatchSize [U]).
    """

    max_sequence_size: int = 1024
    max_consensus_size: int = 0          # 0 -> 2 * max_sequence_size
    max_nodes_per_window: int = 0        # 0 -> 3 * max_sequence_size
    max_sequences_per_poa: int = 16
    band_width: int = 256                # static band for banded graph NW
    max_pred_per_node: int = 4           # CUDAPOA_MAX_NODE_EDGES analog
    max_aligned_per_node: int = 4        # CUDAPOA_MAX_NODE_ALIGNMENTS analog

    def __post_init__(self):
        if self.max_consensus_size == 0:
            object.__setattr__(self, "max_consensus_size", 2 * self.max_sequence_size)
        if self.max_nodes_per_window == 0:
            object.__setattr__(self, "max_nodes_per_window", 3 * self.max_sequence_size)

    @property
    def padded_nodes(self) -> int:
        return _round_up(self.max_nodes_per_window, 8)

    @property
    def padded_seq(self) -> int:
        return _round_up(self.max_sequence_size, 128)


@dataclass(frozen=True)
class MapperConfig:
    """Overlapper parameters (reference: cudamapper CLI flags [U] — exact
    defaults unverified; chosen to match upstream docs where known)."""

    kmer_size: int = 15                # -k
    window_size: int = 15              # -w
    hash_representations: bool = True
    filtering_parameter: float = 1.0   # -F: drop reps with freq > F (1.0 = off)
    min_residues: int = 4              # min anchors per overlap
    min_overlap_len: int = 50
    min_bases_per_residue: int = 100
    min_overlap_fraction: float = 0.95
    max_anchor_gap: int = 5000         # chain trigger: max (qpos,tpos) step
    index_size_mb: int = 30            # -i/-t batching budget (MB of bases)
    skip_self_mappings: bool = True

    def __post_init__(self):
        # hashed mode packs 2k bits into two uint32 words then mixes to a
        # 32-bit representation (ops/sketch.py) -> k up to 31; unhashed mode
        # stores the packed k-mer itself in 32-bit element arrays -> k <= 15.
        if self.hash_representations:
            if not (1 <= self.kmer_size <= 31):
                raise ValueError("kmer_size must be in [1, 31]")
        elif not (1 <= self.kmer_size <= 15):
            raise ValueError(
                "kmer_size must be in [1, 15] when hash_representations "
                "is off (32-bit unhashed representations)")


@dataclass(frozen=True)
class PipelineConfig:
    """Overlap -> alignment pipeline (new composition, BASELINE config #4)."""

    mapper: MapperConfig = field(default_factory=MapperConfig)
    aligner_band_radius: int = 256
    max_alignment_length: int = 16384


@dataclass(frozen=True)
class CorrectConfig:
    """Read-correction driver (new composition, BASELINE config #5):
    all-vs-all map -> per-overlap base-exact alignment -> per-read pileup
    windows -> batched POA consensus -> corrected reads.

    The reference has no correction app; this is the pod-scale composition
    SURVEY.md §7 step 7 names (the compute core of Racon-style polishing,
    which consumes cudapoa; reference: cudapoa/include/claragenomics/
    cudapoa/batch.hpp [U] is the POA surface it drives)."""

    mapper: MapperConfig = field(default_factory=MapperConfig)
    # backbone window size (bases).  128 measured more accurate than the
    # Racon-style 500 (CPU A/B, 60x1.5kb @5%: edit-distance reduction
    # 0.786 vs 0.609): short windows keep supports locally consistent.
    window_length: int = 128
    # supporting segments per window.  7 measured more accurate than 15
    # (1000x5kb: reduction 0.9335 vs 0.9285): past ~7 supports the
    # consensus saturates and extra noisy rows average error back in,
    # while the POA cost grows superlinearly with the pileup depth.
    max_support: int = 7
    min_matched_bases: int = 8        # matched pairs a support must place
    aligner_band_radius: int = 256    # per-overlap re-alignment band
    max_alignment_length: int = 16384 # overlaps longer than this are skipped
    # windows with fewer supports keep the backbone: with a single support
    # every disagreeing column is a 1-vs-1 tie decided by tie-break order,
    # which averages errors in rather than out
    min_supports_for_poa: int = 2
