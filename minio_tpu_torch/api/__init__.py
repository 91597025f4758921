"""The S3 HTTP front end of the port: SigV4/SigV2 verification, the
handlers of the slice's routes, and the threaded server."""
