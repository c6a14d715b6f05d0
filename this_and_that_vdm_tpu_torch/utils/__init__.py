"""Host-side helpers of the entry points: frame files and evaluation metrics."""
