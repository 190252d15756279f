"""The host runtime: the native packer and the inference stream."""
