"""Weight conversion, BN folding and the flagship builder."""
