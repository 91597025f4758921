"""Drive storage of the port: xl.meta, FileInfo and LocalStorage."""
