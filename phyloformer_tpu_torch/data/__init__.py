from .alphabet import ALPHABET, ALPHABET_SIZE, GAP_CODE, decode_codes, encode_bytes
from .fasta import Alignment, has_fasta_ext, read_fasta, write_fasta
from .newick import (Node, parse_newick, patristic_matrix, patristic_vector, read_newick,
                     tree_diameter)
from .msa_tools import concat, dedup, remove_gap_columns, sample, subset, trim
from .pairs import n_pairs, pair_indices, square_to_vector, vector_to_square
from .phylip import matrix_to_phylip, read_phylip, vec_to_phylip

__all__ = [
    "ALPHABET",
    "ALPHABET_SIZE",
    "GAP_CODE",
    "Alignment",
    "Node",
    "decode_codes",
    "encode_bytes",
    "has_fasta_ext",
    "matrix_to_phylip",
    "n_pairs",
    "pair_indices",
    "parse_newick",
    "patristic_matrix",
    "patristic_vector",
    "read_fasta",
    "read_newick",
    "read_phylip",
    "square_to_vector",
    "tree_diameter",
    "vec_to_phylip",
    "vector_to_square",
    "write_fasta",
]
