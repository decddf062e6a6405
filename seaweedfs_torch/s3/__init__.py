"""The S3 half of the port: so far only SigV4 request signing, which the
object-store tier (storage/backend.py ``S3ObjectStore``) signs with."""
