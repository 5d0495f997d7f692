"""Traffic generators, one a module, named by a traffic file's ``driver``."""
