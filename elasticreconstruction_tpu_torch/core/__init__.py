"""Core containers, SE(3) algebra and reference-format file IO."""
