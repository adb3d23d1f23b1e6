from raytracer_odin_tpu_torch.cli import main

raise SystemExit(main())
