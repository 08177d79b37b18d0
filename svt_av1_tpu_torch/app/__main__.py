from svt_av1_tpu_torch.app.cli import main

raise SystemExit(main())
