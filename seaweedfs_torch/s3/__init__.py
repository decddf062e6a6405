"""The S3 half of the port: the gateway over the filer (s3_server.py),
its identities, chunked SigV4 bodies and post policies (auth.py),
Signature V2 (sigv2.py), and the SigV4 request signer (sigv4.py) that
the object-store tier (storage/backend.py ``S3ObjectStore``) signs
with."""
