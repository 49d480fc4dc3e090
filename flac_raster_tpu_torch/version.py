__version__ = "0.3.0"

# Version string written into FLAC VORBIS_COMMENT ENCODER fields; the same
# string as the JAX package's, so both packages write the same comments.
ENCODER_NAME = f"flac-raster-tpu v{__version__}"
