"""SGS turbulence schemes (port of pam_tpu/physics/sgs; ref physics/sgs)."""
