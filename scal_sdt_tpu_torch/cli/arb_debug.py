"""ARB bucket-fit debugger (port of ``scal_sdt_tpu/cli/arb_debug.py``;
reference: lab/check_how_arb_fucks_you.py).

``python -m scal_sdt_tpu_torch.cli.arb_debug --config cfg.yaml --width W
--height H [--list-buckets]``: for an image of (W, H), prints the generated
bucket set, the best-fit bucket, the aspect error, and the pre-crop resize
the ARB pipeline would do. Host-side only: it touches no device.
"""

from __future__ import annotations

import click

from ..conf import load_with_defaults
from ..data.bucket import BucketManager, get_gen_bucket_params
from ..data.datasets import AspectDataset


@click.command()
@click.option("--config", "config_path", type=click.Path(exists=True), required=True,
              help="Training config (aspect_ratio_bucket section is used).")
@click.option("--width", type=int, required=True)
@click.option("--height", type=int, required=True)
@click.option("--list-buckets", is_flag=True, help="Print the whole bucket set.")
def main(config_path, width: int, height: int, list_buckets: bool):
    config = load_with_defaults(config_path)
    manager = BucketManager(1)
    params = get_gen_bucket_params(config.data.resolution, config.aspect_ratio_bucket)
    manager.gen_buckets(**params)

    if list_buckets:
        click.echo(f"Bucket set ({len(manager.buckets)} buckets, params {params}):")
        for b in manager.buckets:
            click.echo(f"  {b.size}  aspect {b.aspect:.4f}")

    aspect = width / height
    best = min(manager.buckets, key=lambda b: abs(b.aspect - aspect))
    error = abs(best.aspect - aspect)
    max_err = config.aspect_ratio_bucket.max_aspect_error
    resize = AspectDataset.preserve_ratio_size((width, height), best.size)

    click.echo(f"image ({width}, {height}) aspect {aspect:.4f}")
    click.echo(f"best bucket {best.size} aspect {best.aspect:.4f}")
    click.echo(f"aspect error {error:.4f} "
               f"({'OK' if error < max_err else 'SKIPPED, exceeds max_aspect_error'})")
    click.echo(f"pre-crop resize -> {resize}, crop -> {best.size}")


if __name__ == "__main__":
    main()
