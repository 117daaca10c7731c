"""Host-side utilities of the port: tokenizers and wav IO."""
