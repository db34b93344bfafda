"""Host-side native code (C++ packer) and its g++ build."""
