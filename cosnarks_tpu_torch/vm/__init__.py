"""circom witness extension: parser, interpreter and its plain, Rep3,
Shamir and batched Rep3 drivers (port of `cosnarks_tpu.vm`)."""
